"""``mx.serving`` — the inference serving tier.

Counterpart of the JAX package's ``serving/__init__.py``, for its stateless
half: :class:`InferenceServer` serves single-forward requests from a
thread-safe queue through a scheduler loop that forms dynamic batches under
a latency SLO (``max_batch_size`` / ``max_queue_ms``), pads them to
(batch, length) shape buckets (:class:`ShapeBucketer`), and routes the
model through a per-server AMP tier; ``serving.*`` spans, ``serving_*``
counters and a metrics provider feed ``profiler.metrics_snapshot()`` and
the Prometheus endpoint.

The autoregressive half (``GenerationServer``, ``SlotKVCache``,
``KVCacheLadder``, ``Tenant``, ``AdmissionError``, ``GenerationResult``)
comes with the next serving slice (ROADMAP §1 item 4); reaching one of
them raises ``AttributeError`` naming that queue.
"""
from .bucketing import ShapeBucketer
from .server import (InferenceServer, PendingResult, ServerDrainingError,
                     install_sigterm_drain)

__all__ = ["InferenceServer", "PendingResult", "ShapeBucketer",
           "ServerDrainingError", "install_sigterm_drain"]

_GENERATION = ("GenerationServer", "GenerationResult", "AdmissionError", "Tenant",
               "KVCacheLadder", "SlotKVCache")


def __getattr__(name):
    if name in _GENERATION:
        raise AttributeError(
            f"serving.{name} is not ported yet: the generation tier (serving/generation.py, "
            f"serving/kv_cache.py) waits in ROADMAP §1 item 4")
    raise AttributeError(f"module 'serving' has no attribute {name!r}")
