"""Carry training state between the JAX reference and the port as numpy.

``state_from_numpy(tree, device)`` takes a reference ``DistGANState``
exported as numpy — a mapping (or an object with the same attributes)
with ``g``, ``g_opt`` (``mu``/``nu``/``step``), the stacked ``ds`` and
``d_opts``, ``server_d`` and ``step`` — and builds the port's state on
``device``.  ``state_to_numpy`` goes the other way.  The reference's PRNG
key is not carried (jax's threefry draws cannot be reproduced): the port's
state gets a fresh host generator seeded with ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.approaches import DistGANState
from repro_torch.models.common import tree_map

_FIELDS = ("g", "g_opt", "ds", "d_opts", "server_d", "step")


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _to_torch(a, device):
    arr = np.array(a, copy=True)          # own, writable memory
    if arr.dtype == np.int32 or arr.dtype == np.int64:
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    return torch.from_numpy(arr.astype(np.float32, copy=False)).to(device)


def state_from_numpy(tree, device, *, seed: int = 0) -> DistGANState:
    """Reference state (numpy leaves) -> the port's DistGANState."""
    conv = {name: tree_map(lambda a: _to_torch(a, device), _get(tree, name))
            for name in _FIELDS}
    return DistGANState(**conv, generator=torch.Generator().manual_seed(seed))


def state_to_numpy(state: DistGANState) -> dict:
    """The port's state -> a dict of numpy leaves (the reference's field
    names; no key)."""
    return {name: tree_map(lambda t: t.detach().cpu().numpy(),
                           getattr(state, name)) for name in _FIELDS}
