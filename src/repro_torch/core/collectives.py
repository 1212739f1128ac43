"""The collectives of the reference's ``shard_map`` over the ``users`` axis
of a :class:`repro_torch.launch.mesh.UsersMesh`, as ``torch.distributed``
calls on the rank's device (NCCL on the card, gloo on the CPU or on CUDA
tensors of ranks sharing a card):

    psum -> all_reduce(SUM)    pmax / pmin -> all_reduce(MAX / MIN) over
    pmean -> SUM / size        order-preserving int32 keys (a NaN loses,
    all_gather -> one tensor   on any rank and any backend, as in the
    axis_index -> the rank     reference's XLA on the CPU)

The reference takes these from ``jax.lax``; here they sit below the
combiners (``core/federated.py``) and the SPMD engines (``core/spmd.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import UsersMesh

# torch >= 2.13 renames all_gather_into_tensor (same arguments)
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def axis_index(mesh: UsersMesh) -> int:
    return mesh.rank


class _Psum(torch.autograd.Function):
    """SUM all-reduce whose backward is a SUM all-reduce of the cotangents:
    psum's transpose with replication unchecked, which approach 2's
    gradient relies on (the reference's ``check_vma=False``).  A float sum
    gets + 0.0, as the reference's XLA all-reduce adds into a +0.0
    accumulator: an all -0.0 sum is +0.0 (gloo and NCCL give -0.0)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        if out.is_floating_point():
            out.add_(0.0)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Psum.apply(grad, ctx.mesh), None


def psum(x: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """Sum over the users axis (differentiable; see ``_Psum``)."""
    return _Psum.apply(x, mesh)


def pmean(x: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    return psum(x, mesh) / mesh.size


_NAN_HI = 0x7FC00000            # +NaN: above +inf in the key order
_NAN_LO = -0x00400000           # -NaN (0xFFC00000): below -inf


def _keys(bits: torch.Tensor) -> torch.Tensor:
    """f32 bit patterns (int32) <-> keys whose int32 order is the floats'
    total order (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN): the
    magnitude bits of a negative float are flipped.  Its own inverse."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _ordered_reduce(x: torch.Tensor, mesh: UsersMesh, op, nan_bits: int):
    if x.dtype != torch.float32:
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=mesh.group)
        return out
    bits = x.contiguous().view(torch.int32)
    keys = _keys(torch.where(torch.isnan(x), torch.full_like(bits, nan_bits),
                             bits))
    dist.all_reduce(keys, op=op, group=mesh.group)
    return _keys(keys).view(torch.float32)


def pmax(x: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """Max over the users axis.  For f32 a NaN loses to every number,
    whichever rank holds it (NaN only where every rank holds one), as the
    reference's XLA pmax on the CPU gives; gloo's MAX would keep a NaN
    held by rank 0 and drop one held elsewhere.  A MAX over
    order-preserving int32 keys, the NaN keyed below -inf."""
    return _ordered_reduce(x, mesh, dist.ReduceOp.MAX, _NAN_LO)


def pmin(x: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """Min over the users axis; for f32 a NaN loses to every number, as in
    ``pmax``."""
    return _ordered_reduce(x, mesh, dist.ReduceOp.MIN, _NAN_HI)


def all_gather(x: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """Every rank's ``x`` stacked by rank: (size, *x.shape)."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty(mesh.size * flat.numel(), dtype=x.dtype,
                      device=x.device)
    _all_gather_single(out, flat, group=mesh.group)
    return out.view((mesh.size,) + tuple(x.shape))


def all_gather_bits(row: torch.Tensor, mesh: UsersMesh) -> torch.Tensor:
    """Every rank's f32 ``row`` on every rank, bit for bit: the bytes the
    reference's one-hot int32 psum (``spmd.py:454-460``) computes."""
    return all_gather(row.view(torch.int32), mesh).view(torch.float32)
