"""DataLoader (counterpart of the JAX package's ``gluon/data/dataloader.py``;
parity: MXNet's ``python/mxnet/gluon/data/dataloader.py``).

Same API: batchify over a Dataset with samplers, ``num_workers``
background workers, prefetching.  Batches are NDArrays on the CPU; with
``pin_memory=True`` their tensors are in page-locked memory (context
``cpu_pinned``), ready for an asynchronous copy to the card.  Worker model:

* ``num_workers>0`` (default path): **process** workers like the
  reference, so Python transforms escape the GIL.  The pool uses the
  *spawn* context (fork is unsafe once CUDA is initialized), the workers
  never touch the card (no CUDA device is visible to them), and they
  return plain numpy batches over pickle, which the parent wraps.
  ``MXNET_MP_CONTEXT=fork`` restores fork for numpy-only datasets.  As
  with every spawn-based loader, script entry points need the standard
  ``if __name__ == "__main__":`` guard.
* ``thread_pool=True``: thread workers with a bounded prefetch queue
  (cheap startup; fine when decode is C++/NumPy, which release the GIL).
"""
from __future__ import annotations

import os as _os
import pickle
import queue as _queue
import tempfile
import threading

import warnings

import numpy as _np
import torch

from ...context import cpu_pinned
from ...io.io import host_array
from ...ndarray.ndarray import NDArray, _wrap
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (parity: ``default_batchify_fn``)."""
    if isinstance(data[0], NDArray):
        return _wrap(torch.stack([d._data for d in data]))
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(items)) for items in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return host_array(arr)


def default_mp_batchify_fn(data):
    """Batchify in a WORKER process: stacks to numpy (the wire format the
    parent re-wraps; parity role of the reference's shared-memory
    ``reduce_ndarray`` path)."""
    first = data[0]
    if isinstance(first, NDArray):
        return _np.stack([_np.asarray(d.asnumpy()) for d in data])
    if isinstance(first, (tuple, list)):
        return tuple(default_mp_batchify_fn(list(items)) for items in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return arr


def _wrap_np(batch):
    if isinstance(batch, tuple):
        return tuple(_wrap_np(b) for b in batch)
    return host_array(batch)


def _pin(batch):
    """The batch with every NDArray's tensor in page-locked memory."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, NDArray):
        return _wrap(batch._data.pin_memory(), cpu_pinned())
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    return batch


# -- process-worker globals (installed by the pool initializer) -----------
_WORKER_STATE = {}


def _mp_init(path, loaded):
    # workers must never claim the card (the parent holds it); CUDA starts
    # lazily, so hiding the devices here comes before any use
    _os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        _WORKER_STATE["dataset"], _WORKER_STATE["batchify"] = pickle.load(f)
    with loaded.get_lock():
        loaded.value += 1


def _mp_make_batch(indices):
    ds = _WORKER_STATE["dataset"]
    return _WORKER_STATE["batchify"]([ds[i] for i in indices])


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size=None,
        shuffle=False,
        sampler=None,
        last_batch=None,
        batch_sampler=None,
        batchify_fn=None,
        num_workers=0,
        pin_memory=False,
        prefetch=None,
        thread_pool=False,
        timeout=120,
    ):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be specified if batch_sampler is specified."
            )
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None else 2 * self._num_workers)
        self._custom_batchify = batchify_fn is not None
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pool = None

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        return self._batchify_fn(samples)

    def __iter__(self):
        pin = self._pin_memory
        if pin and not torch.cuda.is_available():
            warnings.warn("pin_memory=True without a CUDA card: batches stay in pageable "
                          "memory", UserWarning, stacklevel=2)
            pin = False
        for batch in self._batches():
            yield _pin(batch) if pin else batch

    def _batches(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        if self._thread_pool:
            yield from self._threaded_iter()
        else:
            yield from self._mp_iter()

    # -- process workers (the reference's default worker model) ----------
    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            ctx = mp.get_context(_os.environ.get("MXNET_MP_CONTEXT", "spawn"))
            batchify = (self._batchify_fn if self._custom_batchify
                        else default_mp_batchify_fn)
            # the dataset reaches the workers through a file, not through
            # their start pipes: a spawned worker's start blocks until the
            # child has imported the main module and read what it was sent,
            # which would start the workers one after another
            fd, self._pool_file = tempfile.mkstemp(prefix="mxnet_loader_", suffix=".pkl")
            with _os.fdopen(fd, "wb") as f:
                pickle.dump((self._dataset, batchify), f, protocol=pickle.HIGHEST_PROTOCOL)
            self._pool_loaded = ctx.Value("i", 0)
            self._pool = ctx.Pool(self._num_workers, initializer=_mp_init,
                                  initargs=(self._pool_file, self._pool_loaded))
        return self._pool

    def _drop_pool_file(self, force=False):
        path = getattr(self, "_pool_file", None)
        if path is not None and (force or self._pool_loaded.value >= self._num_workers):
            self._pool_file = None
            try:
                _os.unlink(path)
            except OSError:
                pass

    def _mp_iter(self):
        pool = self._get_pool()
        batches = list(self._batch_sampler)
        bound = max(self._prefetch, self._num_workers)
        pending = {}
        nxt = 0
        for i in range(len(batches)):
            while nxt < len(batches) and nxt < i + bound:
                pending[nxt] = pool.apply_async(_mp_make_batch, (batches[nxt],))
                nxt += 1
            batch = pending.pop(i).get(self._timeout)
            self._drop_pool_file()
            yield _wrap_np(batch) if not self._custom_batchify else batch

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            try:
                pool.terminate()
            except Exception:
                pass  # interpreter shutdown: multiprocessing may be torn down
        self._drop_pool_file(force=True)

    def _threaded_iter(self):
        """Bounded-queue worker pool preserving batch order.  Workers stall
        once ``prefetch`` batches are waiting unconsumed, bounding memory."""
        import time as _time

        batches = list(self._batch_sampler)
        bound = max(self._prefetch, self._num_workers)
        out_q: dict[int, object] = {}
        consumed = [0]  # next index the consumer will take
        lock = threading.Lock()
        done = threading.Event()
        work_q = _queue.Queue()
        for i, b in enumerate(batches):
            work_q.put((i, b))

        def worker():
            while not done.is_set():
                try:
                    i, indices = work_q.get_nowait()
                except _queue.Empty:
                    return
                # respect the prefetch bound: don't run ahead of the consumer
                while not done.is_set():
                    with lock:
                        if i < consumed[0] + bound:
                            break
                    _time.sleep(0.001)
                if done.is_set():
                    return
                try:
                    batch = self._make_batch(indices)
                except Exception as e:  # surface in consumer
                    batch = e
                with lock:
                    out_q[i] = batch

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                import time

                deadline = time.time() + self._timeout
                while True:
                    with lock:
                        if i in out_q:
                            batch = out_q.pop(i)
                            consumed[0] = i + 1
                            break
                    if time.time() > deadline:
                        raise RuntimeError(f"DataLoader timed out waiting for batch {i}")
                    time.sleep(0.001)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            done.set()
