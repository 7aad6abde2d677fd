"""Shape bucketing for the serving tier.

Counterpart of the JAX package's ``serving/bucketing.py``.  Every distinct
input shape is its own executor plan, so variable-length traffic is padded
UP to the nearest of a **small closed set of bucket shapes**: after one
warm-up pass every batch the scheduler forms lands on a warm, already-built
``Predictor`` executor.  Powers of two by default (amortized padding waste
<= 2x, bucket count logarithmic in the max length), overridable with an
explicit ladder when the traffic distribution is known.
"""
from __future__ import annotations

import bisect

__all__ = ["ShapeBucketer"]


class ShapeBucketer:
    """Map a length onto a fixed ascending ladder of bucket sizes.

    Parameters
    ----------
    buckets : explicit ascending ladder (iterable of positive ints), or
        None to derive powers of two.
    max_length : largest length the ladder must cover (required when
        ``buckets`` is None).  With explicit buckets it is an optional
        admission CEILING below the ladder's top: lengths past it are
        rejected even though a bucket could hold them (an operator capping
        request size without retuning the ladder).  Never above the top
        bucket — a ceiling the ladder can't serve is a config error.
    min_bucket : smallest derived bucket (default 8 — tinier buckets
        multiply executor plans for negligible padding savings).
    """

    def __init__(self, buckets=None, max_length=None, min_bucket=8):
        if buckets is not None:
            ladder = sorted({int(b) for b in buckets})
            if not ladder or ladder[0] <= 0:
                raise ValueError(f"buckets must be positive ints: {buckets!r}")
            if max_length is not None:
                max_length = int(max_length)
                if max_length <= 0:
                    raise ValueError(f"max_length must be positive, got "
                                     f"{max_length}")
                if max_length > ladder[-1]:
                    raise ValueError(
                        f"max_length {max_length} exceeds the top bucket "
                        f"{ladder[-1]} — requests admitted under that "
                        f"ceiling could never be served")
        else:
            if max_length is None or int(max_length) <= 0:
                raise ValueError(
                    "ShapeBucketer needs max_length to derive buckets")
            max_length = int(max_length)
            b = max(1, int(min_bucket))
            ladder = []
            while b < max_length:
                ladder.append(b)
                b *= 2
            ladder.append(max_length)
        self._buckets = tuple(ladder)
        self._max_length = int(max_length) if max_length is not None \
            else self._buckets[-1]

    @property
    def buckets(self):
        return self._buckets

    @property
    def max_length(self):
        """The admission ceiling: the largest length :meth:`bucket_for`
        accepts.  Servers check requests against this at ``submit()`` so
        an oversized request fails at the door with a clear error instead
        of surfacing as a scheduler-thread failure."""
        return self._max_length

    def bucket_for(self, length):
        """Smallest bucket >= ``length``.  Raises ValueError past the
        ``max_length`` ceiling (the server surfaces this to the submitter
        — a too-long request must fail loudly, not build a new plan)."""
        length = int(length)
        if length < 0:
            raise ValueError(f"negative length {length}")
        if length > self._max_length:
            raise ValueError(
                f"length {length} exceeds max_length {self._max_length} "
                f"(buckets: {list(self._buckets)}) — the request can never "
                f"be served by this ladder")
        i = bisect.bisect_left(self._buckets, length)
        return self._buckets[i]

    def __repr__(self):
        return (f"ShapeBucketer(buckets={list(self._buckets)}, "
                f"max_length={self._max_length})")
