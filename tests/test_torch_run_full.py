"""``scripts/run_full_torch.py`` on the CPU: its parsing of a port
trainer's stage log, and each variant's run at a tiny cut (small volumes,
patch and widths) through the train CLI's core, its JSON with a parsed
``stage ... done:`` line for each stage, the validations and, for
pancreas, the instance-norm biases' largest magnitudes."""

import json
import os
import sys

import pytest

from bcp_tpu_torch.data import feed

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import run_full_torch  # noqa: E402

LOG = """\
[10:00:00.000] config: Config(...)
[10:00:00.500] iteration 1 : loss: 0.9000 loss_ce: 0.7000
{iters}[10:02:05.250] validation@200: dice 0.5000 (eval 1.00s, ckpt 0.10s)
[10:02:06.000] stage self done: 300 steps in 125.5s (0.418 s/step), \
validation+ckpt pauses 3.2s (2.5%), best dice 0.6123
"""

#: (sizes, config overrides, cut) of each variant's tiny run
TINY = {
    "la": (dict(n_train=12, n_val=1, shape=(20, 20, 18)),
           dict(patch_size=(16, 16, 16), n_filters=4, eval_every=2,
                compute_dtype="float32"), (4, 4, 2)),
    "acdc": (dict(n_slices=16, n_val=1, shape=(36, 40), depth=3),
             dict(patch_size=(32, 32), n_filters=4, eval_every=2,
                  compute_dtype="float32", batch_size=8, labeled_bs=4),
             (4, 4, 2)),
    "pancreas": (dict(n_lab=2, n_unlab=4, n_test=1, shape=(20, 20, 18)),
                 dict(patch_size=(16, 16, 16), n_filters=4, mask_patch=8,
                      eval_every=4, compute_dtype="float32"), (1, 2, 1)),
}


def test_parse_stage_log(tmp_path):
    """The summary line's fields and the per-100-iteration blocks of the
    iteration lines' time stamps (0.4 s an iteration here)."""
    iters = "".join(f"[10:{(i * 4) // 600:02d}:{(i * 4) % 600 / 10:06.3f}] "
                    f"iteration {i} : loss: 0.5\n" for i in range(2, 301))
    path = tmp_path / "log.txt"
    path.write_text(LOG.format(iters=iters))
    got = run_full_torch.parse_stage_log(str(path))
    assert got["stage"] == "self"
    assert (got["steps"], got["wall"], got["per"], got["val"],
            got["valpct"], got["dice"]) == (300, 125.5, 0.418, 3.2, 2.5,
                                            0.6123)
    dist = got["block_time_distribution"]
    assert dist["blocks"] == 3
    assert dist["s_per_iter_p50"] == pytest.approx(0.4, abs=1e-3)


def test_pancreas_meter_lines_count_as_iterations(tmp_path):
    lines = "".join(f"[10:00:{i:02d}.000] Epoch : 1, ce_loss: 0.1\n"
                    for i in range(5))
    path = tmp_path / "log.txt"
    path.write_text(lines)
    got = run_full_torch.parse_stage_log(str(path))
    assert "steps" not in got
    assert got["block_time_distribution"]["s_per_iter_max"] == 1.0


@pytest.mark.parametrize("variant", sorted(TINY))
def test_run_at_a_tiny_cut(variant, tmp_path, monkeypatch):
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 7, 8)
    sizes, over, (pre, self_, k) = TINY[variant]
    real = run_full_torch.run
    monkeypatch.setattr(run_full_torch, "run", lambda *a, **kw: real(
        *a, **kw, sizes=sizes, **over))
    out = tmp_path / "run.json"
    assert run_full_torch.main(
        ["--variant", variant, "--pre", str(pre), "--self", str(self_),
         "--k", str(k), "--out", str(out), "--snap", str(tmp_path / "snap"),
         "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert got["variant"] == variant and got["device"] == {
        "platform": "cpu"}
    assert got["schedule"]["cut"] and got["steps_per_dispatch"] == k
    iters = got["schedule"]["iterations"]
    for stage, n in zip(("pre_train", "self_train"), iters):
        s = got["stages"][stage]
        assert s["stage"] == stage.split("_")[0] and s["steps"] == n
        assert 0.0 <= s["dice"] <= 1.0 and s["wall"] > 0
    assert got["validations"] >= 2
    assert got["graph_counts"] == ({} if k == 1 else {
        "pre": {"captures": 0, "replays": 0},
        "self": {"captures": 0, "replays": 0}})
    if variant == "pancreas":
        b = got["instance_norm_biases"]
        assert b["biases"] == 29
        assert b["self_train_last_max_abs_moved"] > 0.0
    else:
        assert "instance_norm_biases" not in got
    with pytest.raises(SystemExit, match="not empty"):
        run_full_torch.main(["--variant", variant, "--snap",
                             str(tmp_path / "snap"), "--device", "cpu"])
