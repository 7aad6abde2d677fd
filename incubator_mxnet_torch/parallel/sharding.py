"""Parameter and batch placement rules.

Counterpart of the JAX package's ``parallel/sharding.py``: an ordered list
of (name regex -> :class:`PartitionSpec`) rules applied to parameter
names, first match wins, then the fallback; a spec that does not divide a
shape replicates that axis.  The rules are built and matched as there.

The port's mesh is pure data parallel, so what a spec may place is the
batch: axis 0 over ``("dp", "fsdp")``, each rank holding its own rows.  A
spec that names an axis for a parameter (tp, fsdp) or a sequence axis
over ``sp`` raises where it would place something, naming ROADMAP §1
item 6b; a replicated spec places the array on the rank's device.
"""
from __future__ import annotations

import dataclasses
import re

import torch

__all__ = ["PartitionSpec", "NamedSharding", "ShardingRules", "default_rules", "fsdp_rules",
           "param_sharding", "batch_pspec", "shard_array", "replicate"]


class PartitionSpec(tuple):
    """One entry an array axis: None (replicated), an axis name, or a tuple
    of axis names (the JAX package's sharding spec)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    @property
    def replicated(self):
        return all(p is None for p in self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX package's named sharding)."""

    mesh: object
    spec: PartitionSpec


def _axis_size(mesh, names) -> int:
    """The size of one spec entry on ``mesh`` (a ``Mesh``, or a mapping of
    axis sizes such as ``MeshConfig.resolve``'s)."""
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = getattr(mesh, "shape", mesh)
    size = 1
    for n in names:
        size *= shape[n]
    return size


class ShardingRules:
    """Ordered (regex -> PartitionSpec) table; first match wins."""

    def __init__(self, rules=(), default=P()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]
        self._default = default

    def add(self, pattern, spec):
        self._rules.append((re.compile(pattern), spec))
        return self

    @property
    def default(self):
        """The fallback spec for names no rule matches."""
        return self._default

    def spec_for(self, name: str, shape, mesh) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(name):
                return _fit_spec(spec, shape, mesh)
        return _fit_spec(self._default, shape, mesh)

    def __iter__(self):
        return iter(self._rules)


def _fit_spec(spec, shape, mesh) -> PartitionSpec:
    """Clip a spec to the rank of ``shape`` and replicate the axes that do
    not divide evenly (the safe-fallback contract)."""
    out = []
    for i, dim in enumerate(shape):
        names = spec[i] if i < len(spec) else None
        if names is not None and dim % _axis_size(mesh, names) != 0:
            names = None
        out.append(names)
    return P(*out)


def default_rules() -> ShardingRules:
    """Replicate everything: pure data parallelism."""
    return ShardingRules()


def fsdp_rules() -> ShardingRules:
    """ZeRO-style: every parameter's axis 0 over 'fsdp' (placed in ROADMAP
    §1 item 6b; the port raises where it would place one)."""
    return ShardingRules(default=P("fsdp"))


def param_sharding(mesh, name: str, shape, rules: ShardingRules) -> NamedSharding:
    return NamedSharding(mesh, rules.spec_for(name, shape, mesh))


def batch_pspec(ndim: int, sp_axis: int | None = None) -> PartitionSpec:
    """Batch spec: axis 0 over (dp, fsdp); optionally a sequence axis over
    'sp' for context parallelism."""
    parts = [None] * ndim
    parts[0] = ("dp", "fsdp")
    if sp_axis is not None and 0 < sp_axis < ndim:
        parts[sp_axis] = "sp"
    return P(*parts)


def _names(entry):
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def check_placeable(spec, what):
    """Raise, naming ROADMAP §1 item 6b, unless ``spec`` is replicated or
    splits only axis 0 over the batch axes (``dp``/``fsdp``)."""
    batch = len(spec) > 0 and set(_names(spec[0])) <= {"dp", "fsdp"}
    rest = spec[1:] if batch else spec
    if any(p is not None for p in rest):
        raise NotImplementedError(
            f"{what}: spec {spec!r} places an axis other than the batch's; tensor, fsdp and "
            "sequence placement wait in ROADMAP §1 item 6b (the port's mesh is pure data "
            "parallel)")


def _on_device(mesh, arr):
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(getattr(arr, "_data", arr))
    return arr.to(mesh.device)


def shard_array(mesh, arr, spec):
    """Place ``arr`` by ``spec``: a batch spec (axis 0 over dp/fsdp) takes
    this rank's rows as given, a replicated one the same array on every
    rank; on the rank's device."""
    check_placeable(PartitionSpec(*spec), "shard_array")
    return _on_device(mesh, arr)


def replicate(mesh, arr):
    return _on_device(mesh, arr)
