"""The fused softmax + overlap-add (``ops/scatter.py::
softmax_scatter_add_windows``) on the CPU: against the JAX evaluator's chunk
(``jax.nn.softmax``, the ``valid`` mask, the in-order XLA loop of
``bcp_tpu/eval/sliding_window.py``), bit for bit against the port's former
``softmax * valid`` then in-order loop, and the wrapper's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu_torch.eval import sliding_window
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.ops.scatter import (MAX_WINDOWS,
                                       scatter_add_windows_reference,
                                       softmax_scatter_add_windows,
                                       softmax_scatter_add_windows_reference)


def _case(seed, C=2, B=6, n_valid=6, X=40, Y=36, Z=28, p=(16, 12, 8)):
    """A score map, a chunk's logits and starts: overlapping windows, one
    repeated, and windows from ``n_valid`` on padded at the origin with
    logits of their own (as the net gives for a padded window)."""
    rng = np.random.default_rng(seed)
    score = rng.random((X, Y, Z, C)).astype(np.float32)
    logits = (3 * rng.normal(size=(B, *p, C))).astype(np.float32)
    starts = np.stack([rng.integers(0, X - p[0] + 1, B),
                       rng.integers(0, Y - p[1] + 1, B),
                       rng.integers(0, Z - p[2] + 1, B)], 1).astype(np.int32)
    starts[1] = starts[0]          # a window repeated
    starts[n_valid:] = 0
    valid = (np.arange(B) < n_valid).astype(np.float32)
    return score, logits, starts, valid


def _jax_chunk(score, logits, starts, valid):
    """The JAX evaluator's chunk after its forward
    (``bcp_tpu/eval/sliding_window.py:155-165``): softmax, the valid mask,
    then the in-order XLA overlap-add loop it runs on the CPU."""
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    probs = probs * jnp.asarray(valid)[:, None, None, None, None]
    patch, C = logits.shape[1:4], logits.shape[-1]
    st = jnp.asarray(starts)

    def body(i, sc):
        s = st[i]
        idx = (s[0], s[1], s[2], 0)
        tile = jax.lax.dynamic_slice(sc, idx, (*patch, C))
        return jax.lax.dynamic_update_slice(sc, tile + probs[i], idx)

    return np.asarray(jax.lax.fori_loop(0, st.shape[0], body,
                                        jnp.asarray(score)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("C,n_valid", [(2, 6), (3, 6), (2, 4), (3, 4)])
def test_fused_matches_jax_chunk(C, n_valid, seed):
    """C = 2 and 3, a repeated window, and a last chunk with 2 padded
    windows. Two softmax implementations differ in the last bit, hence
    rtol = atol = 1e-6."""
    score, logits, starts, valid = _case(seed, C=C, n_valid=n_valid)
    got = torch.from_numpy(score.copy())
    before = softmax_scatter_add_windows.launches
    out = softmax_scatter_add_windows(got, torch.from_numpy(logits), starts,
                                      n_valid)
    assert out is got and softmax_scatter_add_windows.launches == before
    np.testing.assert_allclose(got.numpy(),
                               _jax_chunk(score, logits, starts, valid),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("C,n_valid", [(2, 4), (3, 5), (2, 6)])
def test_dropping_padded_windows_is_bit_exact(C, n_valid, seed):
    """Leaving the padded windows out gives the same bits as the port's
    former chunk: the same softmax times the valid mask, then the in-order
    loop over every window, padded ones included."""
    score, logits, starts, valid = _case(seed, C=C, n_valid=n_valid)
    lt = torch.from_numpy(logits)
    probs = torch.softmax(lt, dim=-1) * torch.from_numpy(valid).view(
        -1, 1, 1, 1, 1)
    want = scatter_add_windows_reference(torch.from_numpy(score.copy()),
                                         probs, starts)
    got = softmax_scatter_add_windows(torch.from_numpy(score.copy()), lt,
                                      starts, n_valid)
    assert torch.equal(got, want)


def test_wrapper_is_the_plain_version_on_the_cpu():
    score, logits, starts, _ = _case(2, n_valid=5)
    a = softmax_scatter_add_windows(torch.from_numpy(score.copy()),
                                    torch.from_numpy(logits),
                                    torch.from_numpy(starts), 5)
    b = softmax_scatter_add_windows_reference(
        torch.from_numpy(score.copy()), torch.from_numpy(logits), starts, 5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_valid", [0, -1, 7])
def test_n_valid_out_of_range_raises(n_valid):
    score, logits, starts, _ = _case(0)
    with pytest.raises(ValueError, match="n_valid"):
        softmax_scatter_add_windows(torch.from_numpy(score),
                                    torch.from_numpy(logits), starts,
                                    n_valid)


def test_more_windows_than_a_launch_takes_raises():
    score, logits, starts, _ = _case(0, B=MAX_WINDOWS + 1,
                                     n_valid=MAX_WINDOWS)
    with pytest.raises(ValueError, match="n_valid"):
        softmax_scatter_add_windows(torch.from_numpy(score),
                                    torch.from_numpy(logits), starts,
                                    MAX_WINDOWS)


def test_non_contiguous_logits_raise():
    score, logits, starts, _ = _case(0)
    # the same values in (B, C, px, py, pz) memory, seen as (B,px,py,pz,C)
    lt = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(logits, -1, 1))).permute(0, 2, 3, 4, 1)
    assert not lt.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        softmax_scatter_add_windows(torch.from_numpy(score), lt, starts, 6)


def test_class_count_mismatch_raises():
    score, logits, starts, _ = _case(0, C=3)
    with pytest.raises(ValueError, match="class counts"):
        softmax_scatter_add_windows(
            torch.from_numpy(score[..., :2].copy()), torch.from_numpy(logits),
            starts, 6)


def test_any_class_count_on_the_cpu():
    """Nine classes, past the two-class kernel (the card takes them in its
    generic kernel: tests/test_torch_kernels_cuda.py)."""
    score, logits, starts, valid = _case(0, C=9, n_valid=5)
    got = softmax_scatter_add_windows(torch.from_numpy(score.copy()),
                                      torch.from_numpy(logits), starts, 5)
    np.testing.assert_allclose(got.numpy(),
                               _jax_chunk(score, logits, starts, valid),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_window_outside_the_map_raises(axis):
    score, logits, starts, _ = _case(0)
    starts[2, axis] = score.shape[axis] - logits.shape[1 + axis] + 1
    with pytest.raises(ValueError, match="outside"):
        softmax_scatter_add_windows(torch.from_numpy(score),
                                    torch.from_numpy(logits), starts, 6)


def test_a_padded_window_outside_the_map_raises():
    score, logits, starts, _ = _case(0, n_valid=4)
    starts[5] = -1
    with pytest.raises(ValueError, match="outside"):
        softmax_scatter_add_windows(torch.from_numpy(score),
                                    torch.from_numpy(logits), starts, 4)


def test_wrong_dtype_raises():
    score, logits, starts, _ = _case(0)
    with pytest.raises(TypeError, match="float32"):
        softmax_scatter_add_windows(torch.from_numpy(score),
                                    torch.from_numpy(logits).double(),
                                    starts, 6)


class _Head(torch.nn.Module):
    """A stand-in net: (B, 1, ...) patches -> (B, 2, ...) logits."""

    def forward(self, x):
        return torch.cat([x, 1.0 - 2.0 * x], dim=1), None


@pytest.mark.parametrize("shape,n_chunks,last", [((28, 16, 20), 2, 2),
                                                 ((28, 16, 24), 3, 1),
                                                 ((28, 22, 20), 3, 4)])
def test_evaluator_sends_each_chunk_with_its_real_windows(
        monkeypatch, shape, n_chunks, last):
    """Every chunk goes to the fused wrapper once, with the chunk's number
    of real windows: the batch, and what is left for the last chunk."""
    seen = []
    real = sliding_window.softmax_scatter_add_windows

    def spy(score, logits, starts, n_valid):
        seen.append((logits.shape[0], len(starts), n_valid))
        return real(score, logits, starts, n_valid)

    monkeypatch.setattr(sliding_window, "softmax_scatter_add_windows", spy)
    ev = SlidingWindowEvaluator(_Head(), (16, 16, 16), 2, 6, 4, batch=4,
                                device="cpu")
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    _, score = ev.infer(img)
    n = len(sliding_window.window_starts(shape, (16, 16, 16), 6, 4))
    assert n == 4 * (n_chunks - 1) + last
    assert seen == [(4, 4, 4)] * (n_chunks - 1) + [(4, 4, last)]
    np.testing.assert_allclose(score.sum(axis=0), 1.0, rtol=1e-6)
