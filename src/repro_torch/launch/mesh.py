"""Meshes (port of the reference's ``launch/mesh.py``): the users mesh of
the SPMD federation, the production mesh the dry run shards over and the
host mesh the train launcher runs on.

The reference maps the federation's users onto a one-axis device mesh and
runs its round inside ``shard_map``.  The port runs one process (rank) per
slice of the ``users`` axis: :func:`spawn_users` starts the ranks and joins
them into one process group, and :func:`make_users_mesh` describes that
group as a :class:`UsersMesh`, which the SPMD engines
(``core/spmd.py``) and ``FederationSession(..., mesh=)`` take.  NCCL runs
one rank per GPU; gloo runs ranks on the CPU (the tests) or, sharing one
card, on CUDA tensors.  The caller names the backend: nothing swaps one
for the other on failure.

``MESH_GLOO`` (``register_mesh_gloo``) is gloo as a host mesh's ranks
use it: DTensor's functional all-gathers and reduce-scatters reach gloo's
one-tensor ``_allgather_base`` / ``_reduce_scatter_base``, every other
collective gloo's own.  On CUDA tensors gloo's list all-gather, which the
functional all-gather goes through, crashes the process (torch 2.11, a
probe of every collective on 4 ranks sharing an H100), where the
one-tensor form works; the numbers are gloo's either way.

``make_production_mesh`` is the reference's layout, ``(data 16, model
16)`` or ``(pod 2, data 16, model 16)``, as a
``torch.distributed.device_mesh.DeviceMesh`` over a fake process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``): this
process is rank 0 and no collective moves data, so the dry run
(``launch/dryrun.py``) runs one rank's share of a step on ``meta``
tensors.  ``make_host_mesh`` is a ``(data, model)`` mesh over the ranks of
an initialized process group (the caller names the backend, as for
``make_users_mesh``).  Both also build the flattened groups of their
adjacent axes, so a sum pending over several axes (a data-parallel
gradient under ``dp_only``) is one all-reduce, as the reference's
compiled programs reduce it.  Importing the module initializes nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as _c10d

from repro_torch.device import resolve_device

AXIS = "users"
PRODUCTION_SHAPE = ((16, 16), ("data", "model"))
MULTI_POD_SHAPE = ((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class UsersMesh:
    """One rank's view of the users axis: its process ``group``, its
    ``rank`` (the reference's ``axis_index``), the axis ``size`` and the
    ``device`` its tensors live on."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = AXIS

    @property
    def shape(self) -> dict:
        """``{"users": size}``, so ``mesh.shape[AXIS]`` reads as in the
        reference."""
        return {self.axis: self.size}


def make_users_mesh(num_users: int, *, backend: str | None = None,
                    device=None) -> UsersMesh:
    """The federation mesh of this rank: one user (slice of the ``users``
    axis) per rank of the initialized default process group, whose world
    size must be ``num_users``.  ``backend`` (``"nccl"`` / ``"gloo"``) must
    be the group's when given.  ``device`` is CUDA unless ``"cpu"`` is
    passed; a CUDA device without an index is card ``rank % count``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_users_mesh needs an initialized process group: run under "
            "spawn_users, or call torch.distributed.init_process_group "
            "first")
    size = dist.get_world_size()
    if size != num_users:
        raise ValueError(f"the users mesh has one rank per user: "
                         f"num_users={num_users}, world size {size}")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} requested, but the process "
                         f"group runs {actual!r}")
    rank = dist.get_rank()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif actual == "nccl":
        raise ValueError("NCCL runs on CUDA tensors; pass a CUDA device or "
                         "use the gloo backend on the CPU")
    return UsersMesh(dist.group.WORLD, rank, size, dev)


def _rank_main(rank: int, fn: Callable, num_users: int, backend: str,
               device: str, init_file: str, out_dir: str, args: tuple,
               timeout_s: float) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=num_users,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_users_mesh(num_users, backend=backend, device=device)
        result = fn(mesh, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_users(fn: Callable, num_users: int, *, backend: str, device,
                init_file: str | None = None, args: tuple = (),
                timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` in ``num_users`` fresh processes, one rank
    each, joined by ``backend`` through a ``file://`` rendezvous (in a
    temporary directory unless ``init_file``, a path that does not exist
    yet, is given: a TCP port could collide between concurrent runs).
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    Ranks on the CPU run one thread each.  Returns ``fn``'s return values
    by rank; a rank that raises fails the call (the others are stopped).
    A collective that waits longer than ``timeout_s`` raises."""
    device = str(device)
    with tempfile.TemporaryDirectory(prefix="users_mesh_") as tmp:
        init = init_file or os.path.join(tmp, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, num_users, backend, device, init, tmp,
                              tuple(args), timeout_s),
            nprocs=num_users, join=True)
        out = []
        for r in range(num_users):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


MESH_GLOO = "mesh_gloo"


class _MeshGloo(dist.ProcessGroup):
    """A gloo process group whose tensor all-gathers and reduce-scatters
    go one tensor at a time through gloo's base forms."""

    def __init__(self, inner, rank: int, size: int):
        super().__init__(rank, size)
        self._inner = inner

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    @property
    def pg_name(self) -> str:
        return self.group_name

    def getBackendName(self) -> str:
        return MESH_GLOO

    def size(self) -> int:
        return self._inner.size()

    def allreduce(self, tensors, opts=_c10d.AllreduceOptions()):
        return self._inner.allreduce(tensors, opts)

    def allreduce_coalesced(self, tensors,
                            opts=_c10d.AllreduceCoalescedOptions()):
        return self._inner.allreduce_coalesced(tensors, opts)

    def barrier(self, opts=_c10d.BarrierOptions()):
        return self._inner.barrier(opts)

    def broadcast(self, tensors, opts=_c10d.BroadcastOptions()):
        return self._inner.broadcast(tensors, opts)

    def allgather(self, outputs, inputs, opts=_c10d.AllgatherOptions()):
        return self._inner.allgather(outputs, inputs, opts)

    def all_gather_single(self, out, inp, opts=_c10d.AllgatherOptions()):
        return self._inner._allgather_base(out, inp, opts)

    def all_gather_single_coalesced(self, outs, inps,
                                    opts=_c10d.AllgatherOptions()):
        return _last(self._inner._allgather_base(o, i, opts)
                     for o, i in zip(outs, inps))

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter_single(self, out, inp,
                              opts=_c10d.ReduceScatterOptions()):
        return self._inner._reduce_scatter_base(out, inp, opts)

    def reduce_scatter_single_coalesced(self, outs, inps,
                                        opts=_c10d.ReduceScatterOptions()):
        return _last(self._inner._reduce_scatter_base(o, i, opts)
                     for o, i in zip(outs, inps))

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, out, inp, out_splits, in_splits,
                          opts=_c10d.AllToAllOptions()):
        return self._inner.alltoall_base(out, inp, out_splits or [],
                                         in_splits or [], opts)

    def alltoall_base(self, out, inp, out_splits, in_splits,
                      opts=_c10d.AllToAllOptions()):
        return self._inner.alltoall_base(out, inp, out_splits, in_splits,
                                         opts)


def _last(works):
    """Wait for every work but the last, and return the last."""
    works = list(works)
    for w in works[:-1]:
        w.wait()
    return works[-1]


def _create_mesh_gloo(store, rank: int, size: int, timeout):
    return _MeshGloo(dist.ProcessGroupGloo(store, rank, size, timeout),
                     rank, size)


def register_mesh_gloo() -> str:
    """Register ``MESH_GLOO`` with ``torch.distributed`` (once a process)
    and return its name, for ``init_process_group``."""
    if MESH_GLOO not in dist.Backend.backend_list:
        dist.Backend.register_backend(MESH_GLOO, _create_mesh_gloo,
                                      devices=["cpu", "cuda"])
    return MESH_GLOO


def _flatten_adjacent(mesh) -> None:
    """The flattened sub-mesh of every run of two or more adjacent axes."""
    names = mesh.mesh_dim_names
    for i in range(len(names)):
        for j in range(i + 2, len(names) + 1):
            mesh[names[i:j]]._flatten()


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` and axis ``names`` over a fake process
    group (this process rank 0): the collectives issue and move nothing.
    Reuses a fake default group of the right size, replaces one of
    another size, and raises when a real group is initialized (the fake
    one needs a process of its own).  The mesh is a "cuda" one where
    this PyTorch has CUDA: the collectives are the ones a mesh of cards
    issues.  Without CUDA it is a "cpu" one, where DTensor issues an
    all-to-all as an all-gather (gloo has none) and its shape
    propagation needs no CUDA."""
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this PyTorch has no fake process group (torch.testing."
            "_internal.distributed.fake_pg): the dry run cannot fake a "
            "mesh") from e
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for d in shape:
        n *= int(d)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is initialized: "
                f"the fake mesh needs a process of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
    _flatten_adjacent(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over a fake group of 256 (``(data,
    model)``) or 512 (``(pod, data, model)``) ranks."""
    shape, names = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    return fake_mesh(shape, names)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``(data, model)`` mesh over the initialized default process group,
    which must hold exactly ``data * model`` ranks.  Its tensors live on
    CUDA unless ``device`` is ``"cpu"`` (gloo ranks on the CPU); a rank's
    card is ``rank % count``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialized process group: run under "
            "torchrun, or call torch.distributed.init_process_group first")
    size = dist.get_world_size()
    if size != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {size}")
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif dist.get_backend() == "nccl":
        raise ValueError("NCCL runs on CUDA tensors; use gloo (MESH_GLOO) "
                         "on the CPU")
    mesh = init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
    _flatten_adjacent(mesh)
    return mesh
