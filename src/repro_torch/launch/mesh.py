"""The users mesh of the SPMD federation on ``torch.distributed`` (port of
the reference's ``launch/mesh.py:47``, ``make_users_mesh``).

The reference maps the federation's users onto a one-axis device mesh and
runs its round inside ``shard_map``.  The port runs one process (rank) per
slice of the ``users`` axis: :func:`spawn_users` starts the ranks and joins
them into one process group, and :func:`make_users_mesh` describes that
group as a :class:`UsersMesh`, which the SPMD engines
(``core/spmd.py``) and ``FederationSession(..., mesh=)`` take.  NCCL runs
one rank per GPU; gloo runs ranks on the CPU (the tests) or, sharing one
card, on CUDA tensors.  The caller names the backend: nothing swaps one
for the other on failure.

Only ``make_users_mesh`` is ported from the reference's file: its TPU
production meshes have no counterpart here.
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

from repro_torch.device import resolve_device

AXIS = "users"


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
