"""``mx.serving`` — the inference serving tier.

Counterpart of the JAX package's ``serving/__init__.py``.  Two servers:

* :class:`InferenceServer` serves single-forward requests from a
  thread-safe queue through a scheduler loop that forms dynamic batches
  under a latency SLO (``max_batch_size`` / ``max_queue_ms``), pads them to
  (batch, length) shape buckets (:class:`ShapeBucketer`), and routes the
  model through a per-server AMP tier;
* :class:`GenerationServer` decodes autoregressively with iteration-level
  **continuous batching** over a device-resident slot KV cache
  (:class:`SlotKVCache` pools of a :class:`KVCacheLadder`): finished
  sequences leave and queued prefills join between decode steps; a
  streaming token surface (:class:`GenerationResult`), mid-stream
  cancellation, and multi-tenant admission control (per-tenant queue caps,
  slot caps, TTFT/TPOT SLOs, queue-depth load shedding →
  :class:`AdmissionError`).

Both record ``serving.*``/``generation.*`` spans, ``serving_*``/
``generation_*`` counters and a metrics provider feeding
``profiler.metrics_snapshot()`` and the Prometheus endpoint.
"""
from .bucketing import ShapeBucketer
from .generation import AdmissionError, GenerationResult, GenerationServer, Tenant
from .kv_cache import KVCacheLadder, SlotKVCache
from .server import (InferenceServer, PendingResult, ServerDrainingError,
                     install_sigterm_drain)

__all__ = ["InferenceServer", "PendingResult", "ShapeBucketer", "GenerationServer",
           "GenerationResult", "AdmissionError", "Tenant", "KVCacheLadder", "SlotKVCache",
           "ServerDrainingError", "install_sigterm_drain"]
