"""An ordered background worker: the JAX package's ``_ValWorker``
(`bcp_tpu/train/trainer.py:49-112`) for the port."""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional

import torch


class OrderedWorker:
    """One background thread running jobs strictly in submission order
    (`trainer.py:49-112`): the trainer's validations and checkpoint
    writes, the test CLIs' NIfTI dumps. ``depth`` bounds the jobs in
    flight, and so the state snapshots alive on the device: a submit
    blocks only while ``depth`` jobs are unfinished. On a CUDA
    device the jobs run on a stream of the worker's own, so their kernels
    and copies queue beside the training stream's, not behind them; a job
    waits itself for the event of whatever it reads. A job's error is
    re-raised in the submitting thread, at the next submit or drain."""

    def __init__(self, depth: int = 1, device=None):
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[Exception] = None
        self._slots = threading.BoundedSemaphore(max(int(depth), 1))
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                job = self._q.get()
                try:
                    if job is not None and self._err is None:
                        job()
                        if self._stream is not None:
                            # what the job read may be freed once it is done
                            self._stream.synchronize()
                except Exception as e:  # raised again in submit or drain
                    self._err = e
                finally:
                    if job is not None:
                        self._slots.release()
                    self._q.task_done()
                if job is None:
                    return

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job) -> None:
        """Queue a job, waiting until fewer than ``depth`` are in flight.
        Re-raises a previous job's error instead of queueing onto it."""
        self._raise_pending()
        self._slots.acquire()
        self._q.put(job)

    def drain(self) -> None:
        """Block until every submitted job has finished; re-raise the
        first job error in the caller's thread."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
