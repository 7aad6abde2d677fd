"""The mesh of the port: one process a card, and the ``dp`` axis is the
``torch.distributed`` world.

Counterpart of the JAX package's ``parallel/mesh.py``.  There one process
drives every device of a host and a JAX device mesh names them; here
each card has its own process, a :class:`Mesh` records the axis sizes, the
process group and this rank's device, and a collective is a call of
``torch.distributed`` on that group.  The axis names and the divisor
rules are the JAX package's (:class:`MeshConfig`), and ``dp`` fills the
world.  With no process group, or a world of 1, the mesh has dp = 1 and a
step launches no collective, as a psum over a size-1 axis compiles to
nothing in the JAX package.

``init_distributed`` reads the reference launcher's ``DMLC_*`` contract
(``tools/launch_local.py`` sets it) and starts the process group over
``tcp://``: NCCL for a card, gloo for the CPU, or the ``backend`` the
caller names (ranks that share one card pass ``"gloo"``).
``sync_profiler_clock`` samples this process's clock offset against rank
0 over the group, for the profiler's process metadata.

Every collective of the port goes through :func:`collective`, which
counts it by backend (:func:`collective_counts`): a step at world 1 must
count none.

Only the pure data-parallel layout is ported: axes other than ``dp`` are
accepted in the configuration (their divisor rules hold), and a mesh in
which one of them is above 1 raises, naming ROADMAP §1 item 6b (item 8
for ``pp``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["MeshConfig", "Mesh", "make_mesh", "current_mesh", "local_mesh", "init_distributed",
           "mesh_scope", "sync_profiler_clock", "collective", "collective_counts",
           "reset_collective_counts", "AXES"]

# Outermost to innermost, as in the JAX package.
AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

_tls = threading.local()
_counts = {"nccl": 0, "gloo": 0}
_counts_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.  ``dp=None`` means "whatever is left over"
    after the explicit axes divide the world."""

    dp: int | None = None
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict:
        fixed = self.fsdp * self.tp * self.pp * self.sp * self.ep
        dp = self.dp
        if dp is None:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by fsdp*tp*pp*sp*ep = {fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(f"mesh {dp}x{self.fsdp}x{self.tp}x{self.pp}x{self.sp}x{self.ep}"
                             f" != device count {n_devices}")
        return dict(dp=dp, fsdp=self.fsdp, tp=self.tp, pp=self.pp, sp=self.sp, ep=self.ep)


class Mesh:
    """A pure data-parallel mesh over the ranks of a process group.

    ``shape`` maps each axis of ``AXES`` to its size (all 1 but ``dp``),
    ``devices`` holds one entry a rank (the rank's index: the port's mesh
    is over processes, each with its own device), ``group`` is the process
    group (None at world 1), ``rank`` this process's rank in it and
    ``device`` this rank's ``torch.device``."""

    axis_names = AXES

    def __init__(self, sizes, device, group=None, rank=0):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.size = int(np.prod(list(self.shape.values())))
        self.devices = np.arange(self.size).reshape(tuple(self.shape[a] for a in AXES))
        self.device = torch.device(device)
        self.group = group
        self.rank = int(rank)

    @property
    def world(self):
        """The ranks of the mesh (the dp axis)."""
        return self.shape["dp"]

    @property
    def backend(self):
        """The process group's backend (``"nccl"`` or ``"gloo"``), None at
        world 1."""
        return None if self.group is None else dist.get_backend(self.group)

    def all_reduce(self, tensor, async_op=False):
        """Sum ``tensor`` over the mesh's ranks in place (a counted
        collective); nothing at world 1."""
        if self.group is None:
            return None
        return collective("all_reduce", tensor, group=self.group, async_op=async_op)

    def broadcast(self, tensor, src=0):
        """Rank ``src``'s ``tensor`` to every rank, in place; nothing at world 1."""
        if self.group is not None:
            collective("broadcast", tensor, group=self.group, src=src)

    def __repr__(self):
        return (f"Mesh({', '.join(f'{a}={self.shape[a]}' for a in AXES)}, device={self.device}, "
                f"rank={self.rank}, backend={self.backend})")


def collective(kind, tensor, group=None, async_op=False, **kwargs):
    """One ``torch.distributed`` call of ``kind`` (``all_reduce``,
    ``broadcast`` or ``barrier``), counted under the group's backend."""
    backend = dist.get_backend(group)
    with _counts_lock:
        _counts[backend] = _counts.get(backend, 0) + 1
    if kind == "barrier":
        return dist.barrier(group=group, async_op=async_op)
    if kind == "all_reduce":
        return dist.all_reduce(tensor, op=kwargs.pop("op", dist.ReduceOp.SUM), group=group,
                               async_op=async_op)
    if kind == "broadcast":
        return dist.broadcast(tensor, src=kwargs.pop("src", 0), group=group, async_op=async_op)
    raise ValueError(f"unknown collective {kind!r}")


def collective_counts():
    """``{backend: collectives}`` the port has issued in this process."""
    with _counts_lock:
        return dict(_counts)


def reset_collective_counts():
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _default_device(rank):
    """The card of this rank: ``cuda:LOCAL_RANK`` (else the rank modulo the
    cards); with no card it raises, since the CPU is taken only when asked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA card; the port runs on the card unless asked for the CPU: "
            "pass devices=['cpu'] * world_size")
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def _as_device(d):
    return getattr(d, "device", None) or torch.device(d)


def make_mesh(config: MeshConfig | None = None, devices=None, **axis_sizes) -> Mesh:
    """Build the mesh.  ``make_mesh()`` is pure dp over the world of the
    process group (dp = 1 without one).  ``devices`` gives each rank's
    device, one entry a rank (``['cpu'] * world`` for a CPU cohort); a list
    of ONE device makes a mesh of this process alone (dp = 1, no group),
    whatever the world."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    world, rank = _world()
    if devices is not None:
        devices = list(devices)
        if len(devices) == 1:
            world, rank = 1, 0
        elif len(devices) != world:
            raise ValueError(f"make_mesh: {len(devices)} devices for a world of {world} ranks "
                             "(give one a rank, or one for a mesh of this process alone)")
    sizes = config.resolve(world)
    for axis in ("fsdp", "tp", "sp", "ep", "pp"):
        if sizes[axis] > 1:
            item = "8" if axis == "pp" else "6b"
            raise NotImplementedError(
                f"make_mesh({axis}={sizes[axis]}): only the data-parallel axis is ported; "
                f"{axis} placement waits in ROADMAP §1 item {item}")
    device = _as_device(devices[rank]) if devices is not None else _default_device(rank)
    return Mesh(sizes, device, group=dist.group.WORLD if world > 1 else None, rank=rank)


def local_mesh() -> Mesh:
    """Pure data-parallel mesh over the world (the reference's default
    ``ctx=[gpu(i) for i in range(num_gpus())]``, one process a card)."""
    return make_mesh(MeshConfig())


def current_mesh() -> Mesh | None:
    return getattr(_tls, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    """Scope a default mesh for ``SPMDTrainer``."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None):
    """Start the process group (the scheduler-role analog of ps-lite's
    ``DMLC_PS_ROOT_URI`` wiring).  Omitted arguments come from the
    reference launcher's environment: ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``
    the coordinator, ``DMLC_NUM_WORKER`` the world size, ``DMLC_WORKER_ID``
    the rank.  ``backend`` defaults to ``"nccl"`` where a card is present
    and ``"gloo"`` on the CPU; ranks that share one card pass ``"gloo"``.
    With no coordinator this is a single process and nothing starts."""
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9000")
        if uri:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None:
        nw = os.environ.get("DMLC_NUM_WORKER")
        num_processes = int(nw) if nw else None
    if process_id is None:
        wid = os.environ.get("DMLC_WORKER_ID")
        process_id = int(wid) if wid else None
    if coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_default_device(process_id or 0))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    if os.environ.get("MXNET_PROFILER_CLOCK_SYNC", "1") != "0":
        # every process that reaches the rendezvous above also reaches this
        sync_profiler_clock()


def _clock_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_profiler_clock(samples=3):
    """One-shot clock-offset estimate against rank 0: broadcast rank 0's wall
    clock over the group and attribute it to the local send/receive
    midpoint, the min-RTT sample winning (``profiler.update_clock_offset``).
    Collective: every rank calls it the same number of times.  Never raises:
    observability must not take bootstrap down."""
    from .. import profiler

    world, rank = _world()
    if world <= 1:
        return None
    try:
        profiler.set_process_info(rank=rank)
        buf = torch.zeros(2, dtype=torch.int64, device=_clock_device())

        def one_round():
            t0 = time.time()
            now = time.time()
            buf.copy_(torch.tensor([int(now), int((now % 1.0) * 1e6)], dtype=torch.int64))
            collective("broadcast", buf, src=0)
            sec, usec = buf.tolist()
            t1 = time.time()
            return (t0 + t1) / 2.0 - (sec + usec / 1e6), t1 - t0

        # a warm-up round, discarded: rank 0's clock is read at ITS entry, so
        # a late rank would see a stale reference inside a short window; the
        # warm-up releases every rank from the same instant
        one_round()
        best = min((one_round() for _ in range(max(1, int(samples)))), key=lambda s: s[1])
        profiler.update_clock_offset(*best)
        return best
    except (RuntimeError, ValueError):
        return None
