"""Slot-based, device-resident KV cache for autoregressive serving.

Counterpart of the JAX package's ``serving/kv_cache.py``.  The decode loop
of :class:`~.generation.GenerationServer` runs ONE step program over a
fixed-capacity cache: requests do not own tensors, they own **slots**,
rows of pre-allocated device buffers.  A request joining the batch costs a
slot allocation (a host free-list pop) plus one memory-insert call; a
request leaving costs nothing on the device (the slot is marked free and
its rows are overwritten by the next occupant before they are read).  So
every program is shaped by the POOL, never by the traffic.

Capacity is **bucketed by a max-length ladder**: one :class:`SlotKVCache`
pool per total-decode-length bucket, so a 16-token completion does not pay
attention over the 512-position cache sized for the long tail.
:class:`KVCacheLadder` owns the pools and routes an admission to the
smallest bucket that covers the request's token budget.

This module is model-free bookkeeping: device buffers are plain zero
tensors with the layouts

* ``self_k`` / ``self_v``: ``[layers, slots, bucket, heads, head_dim]``
  (the per-slot decoded-token cache, written at ``pos[slot]`` each step),
* ``mem_k`` / ``mem_v``: ``[layers, slots, mem_width, heads, head_dim]``
  (the per-slot prefill product: the encoder memory through each decoder
  layer's KV projection, masked by ``mem_len``),

while the programs that read and write them live with the model adapter
in ``serving/generation.py``.  Host-side per-slot state (``pos``,
``mem_len``, ``last_token``, ``active``) is numpy: join and leave are pure
array indexing.
"""
from __future__ import annotations

import weakref as _weakref

import numpy as _np
import torch

from .. import profiler as _profiler
from ..base import as_torch_dtype
from ..context import current_context
from .bucketing import ShapeBucketer

__all__ = ["SlotKVCache", "KVCacheLadder"]


def _release_pool_memory(bucket, nbytes):
    """weakref.finalize hook: a released or collected pool's buffers leave
    the device-memory ledger (module-level: must not reference the pool)."""
    _profiler.track_memory(f"kv_cache.pool_{bucket}", "kv_cache").free(nbytes)


class SlotKVCache:
    """One fixed-capacity pool of KV slots at a single length bucket.

    Parameters
    ----------
    layers, heads, head_dim : decoder geometry.
    slots : pool capacity (concurrent requests at this bucket).
    bucket : decode-position capacity per slot (the total-length bucket).
    mem_width : per-slot memory (prefill) width, the top of the prompt
        ladder, shared across pools.
    dtype : cache dtype (default float32).
    device : where the buffers live (default the current context: the
        card).
    """

    def __init__(self, layers, slots, bucket, mem_width, heads, head_dim, dtype="float32",
                 device=None):
        if slots <= 0 or bucket <= 0 or mem_width <= 0:
            raise ValueError(f"SlotKVCache needs positive slots/bucket/mem_width, got "
                             f"{slots}/{bucket}/{mem_width}")
        self.layers = int(layers)
        self.slots = int(slots)
        self.bucket = int(bucket)
        self.mem_width = int(mem_width)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.dtype = as_torch_dtype(dtype)
        if device is None:
            device = current_context().device
        kv_shape = (self.layers, self.slots, self.bucket, self.heads, self.head_dim)
        mem_shape = (self.layers, self.slots, self.mem_width, self.heads, self.head_dim)
        # the ONLY device allocations this pool ever makes; every later
        # change is a program's in-place update of these
        self.state = {
            "self_k": torch.zeros(kv_shape, dtype=self.dtype, device=device),
            "self_v": torch.zeros(kv_shape, dtype=self.dtype, device=device),
            "mem_k": torch.zeros(mem_shape, dtype=self.dtype, device=device),
            "mem_v": torch.zeros(mem_shape, dtype=self.dtype, device=device),
        }
        # device-memory ledger: one shared owner per bucket (pools of two
        # servers at one bucket compose by deltas).  The bytes follow the
        # buffers, not this object: ownership passes to a StatefulExecutor
        # (generation.py sets pool.state = None), and in-place updates
        # keep every size, so the total registered here is exact until
        # release() or collection.
        self.nbytes = sum(_profiler.array_nbytes(a) for a in self.state.values())
        _profiler.track_memory(f"kv_cache.pool_{self.bucket}", "kv_cache").alloc(self.nbytes)
        self._mem_finalizer = _weakref.finalize(self, _release_pool_memory, self.bucket,
                                                self.nbytes)
        # host-side per-slot registers (pure indexing on join/leave)
        self.pos = _np.zeros(self.slots, _np.int32)
        self.last_token = _np.zeros(self.slots, _np.int32)
        # mem_len stays >= 1 even for free slots: a cross-attention row with
        # no valid key would softmax over an all-masked set and write NaN
        # into the pool's shared buffers
        self.mem_len = _np.ones(self.slots, _np.int32)
        self.active = _np.zeros(self.slots, bool)
        self.owners = [None] * self.slots
        self._free = list(range(self.slots - 1, -1, -1))
        self.joins = 0
        self.leaves = 0

    # -- slot lifecycle -------------------------------------------------
    def alloc(self, owner, mem_len, first_token):
        """Claim a free slot for ``owner``; returns the slot index or
        ``None`` when the pool is full.  The caller inserts the request's
        memory into this slot before the next decode step reads it."""
        if not self._free:
            return None
        s = self._free.pop()
        self.pos[s] = 0
        self.last_token[s] = int(first_token)
        self.mem_len[s] = max(1, int(mem_len))
        self.active[s] = True
        self.owners[s] = owner
        self.joins += 1
        return s

    def free(self, slot):
        """Release a slot.  Device rows are NOT cleared: the decode step
        writes position ``pos`` before attending to it, and the mask ``<=
        pos`` hides everything beyond, so a new occupant never reads its
        predecessor's rows."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.owners[slot] = None
        self.mem_len[slot] = 1
        self.pos[slot] = 0
        self._free.append(slot)
        self.leaves += 1

    @property
    def n_active(self):
        return int(self.active.sum())

    @property
    def n_free(self):
        return len(self._free)

    def active_slots(self):
        """Indices of live slots, ascending (the scheduler's fan-out order is
        deterministic)."""
        return _np.nonzero(self.active)[0]

    def release(self):
        """Release this pool's share of the device-memory ledger (the
        buffers themselves die with their executor).  Idempotent."""
        self._mem_finalizer()

    def stats(self):
        return {"bucket": self.bucket, "slots": self.slots, "active": self.n_active,
                "free": self.n_free, "joins": self.joins, "leaves": self.leaves,
                "nbytes": self.nbytes}

    def __repr__(self):
        return (f"SlotKVCache(bucket={self.bucket}, slots={self.slots}, "
                f"active={self.n_active}/{self.slots})")


class KVCacheLadder:
    """Pools over a total-decode-length ladder.

    A request admits into the smallest bucket covering its token budget
    (independent of the prompt: the decode cache holds only GENERATED
    positions; the prompt lives in the ``mem_*`` buffers at
    ``mem_width``).

    Parameters
    ----------
    layers, heads, head_dim, mem_width, dtype, device : passed to every
        pool.
    buckets : explicit decode-length ladder, or None to derive powers of
        two up to ``max_length`` (:class:`ShapeBucketer` rules).
    max_length : ladder cover when ``buckets`` is None, and the hard
        admission ceiling either way.
    slots_per_bucket : pool capacity, an int for all pools or a dict
        ``{bucket: slots}`` (missing buckets fall back to ``"default"``,
        else 4).
    """

    def __init__(self, layers, heads, head_dim, mem_width, *, buckets=None, max_length=None,
                 slots_per_bucket=4, min_bucket=8, dtype="float32", device=None):
        self._bucketer = ShapeBucketer(buckets=buckets, max_length=max_length,
                                       min_bucket=min_bucket)
        self.pools = {}
        for b in self._bucketer.buckets:
            n = (slots_per_bucket.get(b, slots_per_bucket.get("default", 4))
                 if isinstance(slots_per_bucket, dict) else int(slots_per_bucket))
            self.pools[b] = SlotKVCache(layers, n, b, mem_width, heads, head_dim, dtype=dtype,
                                        device=device)

    @property
    def buckets(self):
        return self._bucketer.buckets

    @property
    def max_length(self):
        return self._bucketer.max_length

    def bucket_for(self, total_len):
        """Smallest bucket covering ``total_len`` (ValueError past the
        ladder: admission rejects at submit, not here)."""
        return self._bucketer.bucket_for(total_len)

    def try_alloc(self, total_len, owner, mem_len, first_token):
        """Allocate a slot in the smallest covering pool with capacity,
        walking UP the ladder when the tight pool is full (a long-bucket
        slot can serve a short request; the reverse cannot).  Returns
        ``(pool, slot)`` or ``None`` when every covering pool is full."""
        start = self._bucketer.bucket_for(total_len)
        for b in self._bucketer.buckets:
            if b < start:
                continue
            s = self.pools[b].alloc(owner, mem_len, first_token)
            if s is not None:
                return self.pools[b], s
        return None

    @property
    def n_active(self):
        return sum(p.n_active for p in self.pools.values())

    @property
    def n_slots(self):
        return sum(p.slots for p in self.pools.values())

    @property
    def nbytes(self):
        return sum(p.nbytes for p in self.pools.values())

    def release(self):
        """Release every pool's ledger share (``GenerationServer.close``
        calls this).  Idempotent."""
        for p in self.pools.values():
            p.release()

    def stats(self):
        return {"buckets": {b: p.stats() for b, p in self.pools.items()},
                "active": self.n_active, "slots": self.n_slots, "nbytes": self.nbytes}

    def __repr__(self):
        return f"KVCacheLadder({[repr(p) for p in self.pools.values()]})"
