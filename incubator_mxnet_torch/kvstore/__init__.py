"""The key-value store (parity: ``mx.kvstore`` / ``mx.kv``): local and
``dist_sync`` stores over ``torch.distributed`` and the bucketed gradient
all-reduce (``kvstore.py``)."""
from .kvstore import (KVStore, KVStoreLocal, KVStoreDist, bucket_bytes, bucketed_pushpull,
                      plan_buckets, execute_bucket, launch_bucket, finish_bucket, create)

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDist", "bucket_bytes", "bucketed_pushpull",
           "plan_buckets", "execute_bucket", "launch_bucket", "finish_bucket", "create"]

# The JAX package's asynchronous parameter server and its errors.
_QUEUED = ("KVStoreDistAsync", "PSError", "PSKeyError", "PSProtocolError", "PSTimeoutError",
           "ParameterServer", "AsyncClient", "retain_feedback")


def __getattr__(name):
    if name in _QUEUED:
        item = "6b" if name == "retain_feedback" else "9"
        raise AttributeError(f"mx.kvstore.{name} is not ported yet: it waits in ROADMAP §1 "
                             f"item {item}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
