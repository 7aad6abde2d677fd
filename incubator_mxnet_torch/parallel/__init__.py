"""Parallelism and distribution: the port's data-parallel tier.

Counterpart of the JAX package's ``parallel/``.  One process drives one
card, and the mesh's dp axis is the ``torch.distributed`` world:

* :mod:`mesh`: ``MeshConfig``, ``make_mesh`` (pure dp over the world),
  ``init_distributed`` (the ``DMLC_*`` launcher contract onto
  ``init_process_group``), ``sync_profiler_clock``, the counted collectives;
* :mod:`sharding`: the name -> ``PartitionSpec`` rules, the batch spec;
* :mod:`trainer`: ``SPMDTrainer``, a block, a loss and an optimizer as one
  data-parallel step (a CUDA-graph replay at world 1).

The JAX package's other names wait in ROADMAP §1: ring attention and the
pipeline schedules in item 8, the elastic tier in item 9; tensor, fsdp and
sequence placement in item 6b.  Each raises at access, naming its item.
"""
from .mesh import (MeshConfig, Mesh, make_mesh, current_mesh, local_mesh, init_distributed,
                   mesh_scope, sync_profiler_clock)
from .sharding import (PartitionSpec, ShardingRules, default_rules, fsdp_rules, param_sharding,
                       batch_pspec, shard_array, replicate)
from .trainer import SPMDTrainer

__all__ = ["MeshConfig", "Mesh", "make_mesh", "current_mesh", "local_mesh", "init_distributed",
           "mesh_scope", "sync_profiler_clock", "PartitionSpec", "ShardingRules",
           "default_rules", "fsdp_rules", "param_sharding", "batch_pspec", "shard_array",
           "replicate", "SPMDTrainer"]

# The JAX package's parallel/ names that wait in ROADMAP §1, by item.
_QUEUED = {
    "8": ("ring_attention", "ring_attention_sharded", "pipeline_apply", "stack_stage_params",
          "build_schedule", "simulate_schedule", "analytic_bubble_fraction",
          "pipeline_value_and_grad", "schedule", "pipeline", "ring"),
    "9": ("elastic", "CollectiveWatchdog", "ElasticClient", "RunCheckpoint"),
}
_ITEM_OF = {name: item for item, names in _QUEUED.items() for name in names}


def __getattr__(name):
    item = _ITEM_OF.get(name)
    if item is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    raise AttributeError(f"mx.parallel.{name} is not ported yet: it waits in ROADMAP §1 item "
                         f"{item}")
