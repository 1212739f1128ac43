"""Carry parameters and training state between the JAX reference and the
port as numpy.

``params_from_numpy(tree, device, dtype=None)`` takes any nested dict of
numpy floating leaves (a model's parameter tree exported from JAX, bf16
leaves included) and builds the port's tree of tensors on ``device``;
``params_to_numpy`` goes the other way.

``state_from_numpy(tree, device)`` takes a reference ``DistGANState``
exported as numpy — a mapping (or an object with the same attributes)
with ``g``, ``g_opt`` (``mu``/``nu``/``step``), the stacked ``ds`` and
``d_opts``, ``server_d`` and ``step`` — and builds the port's state on
``device``.  ``state_to_numpy`` goes the other way.  The reference's PRNG
key is not carried (jax's threefry draws cannot be reproduced): the port's
state gets a fresh host generator seeded with ``seed``.

For the SPMD engines (``core/spmd.py``), ``state_from_numpy(..., mesh=)``
keeps rank r's slice r of the stacked ``ds`` / ``d_opts``, and
``cohort_state_from_numpy(..., mesh=)`` rank r's block of a reference
``CohortState``'s store (the sharded store); both sides then start from
the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.approaches import DistGANState
from repro_torch.core.engine import CohortShared, CohortState
from repro_torch.core.federated import CohortStore
from repro_torch.core.spmd import shard_cohort_state, shard_state
from repro_torch.models.common import dtype_of, tree_map

_FIELDS = ("g", "g_opt", "ds", "d_opts", "server_d", "step")


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _to_torch(a, device):
    arr = np.array(a, copy=True)          # own, writable memory
    if arr.dtype == np.int32 or arr.dtype == np.int64:
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    return torch.from_numpy(arr.astype(np.float32, copy=False)).to(device)


def state_from_numpy(tree, device, *, seed: int = 0,
                     mesh=None) -> DistGANState:
    """Reference state (numpy leaves) -> the port's DistGANState; with a
    users ``mesh``, this rank's (``spmd.shard_state``) on the mesh's
    device."""
    if mesh is not None:
        return shard_state(state_from_numpy(tree, mesh.device, seed=seed),
                           mesh)
    conv = {name: tree_map(lambda a: _to_torch(a, device), _get(tree, name))
            for name in _FIELDS}
    return DistGANState(**conv, generator=torch.Generator().manual_seed(seed))


def cohort_state_from_numpy(tree, device, *, seed: int = 0,
                            mesh=None) -> CohortState:
    """Reference ``CohortState`` (numpy leaves; ``store`` a mapping or an
    object with ``d_flat``, ``opt_flat``, ``last_round`` and ``residual``)
    -> the port's; with a users ``mesh``, this rank's block of the store
    (``spmd.shard_cohort_state``) on the mesh's device."""
    if mesh is not None:
        return shard_cohort_state(
            cohort_state_from_numpy(tree, mesh.device, seed=seed), mesh)
    conv = {name: tree_map(lambda a: _to_torch(a, device), _get(tree, name))
            for name in ("g", "g_opt", "server_d", "step")}
    st = _get(tree, "store")
    store = CohortStore(*(None if _get(st, f) is None
                          else _to_torch(_get(st, f), device)
                          for f in ("d_flat", "opt_flat", "last_round",
                                    "residual")))
    return CohortState(conv["g"], conv["g_opt"], store, conv["server_d"],
                       conv["step"], torch.Generator().manual_seed(seed))


def shared_from_numpy(tree, device, *, seed: int = 0) -> CohortShared:
    """Reference ``CohortShared`` (numpy leaves; a mapping or an object
    with the same attributes) -> the port's, with a fresh host generator
    seeded with ``seed``."""
    conv = {name: tree_map(lambda a: _to_torch(a, device), _get(tree, name))
            for name in ("g", "g_opt", "server_d", "step")}
    return CohortShared(**conv, generator=torch.Generator().manual_seed(seed))


def state_to_numpy(state: DistGANState) -> dict:
    """The port's state -> a dict of numpy leaves (the reference's field
    names; no key)."""
    return {name: tree_map(lambda t: t.detach().cpu().numpy(),
                           getattr(state, name)) for name in _FIELDS}


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of numpy floating leaves -> the same dict of tensors on
    ``device`` in ``dtype`` (a ``torch.dtype`` or a config name such as
    ``"bfloat16"``; default f32).  Every leaf goes through f32, which holds
    bf16, f16 and f32 values exactly, so ml_dtypes' bfloat16 (what JAX
    exports) needs no ml_dtypes here."""
    if isinstance(dtype, str):
        dtype = dtype_of(dtype)
    dtype = dtype or torch.float32

    def leaf(a):
        arr = np.asarray(a).astype(np.float32)        # a fresh copy
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return tree_map(leaf, tree)


def params_to_numpy(params) -> dict:
    """The port's parameter tree -> the same nested dict of numpy leaves
    (f32 for bf16 tensors, which numpy cannot hold; other types as they
    are)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return tree_map(leaf, params)
