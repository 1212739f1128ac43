"""Logical-axis sharding rules with divisibility fallback (port of the
reference's ``sharding/rules.py``).

Every parameter and activation is annotated with *logical* axis names
("embed", "heads", "ffn", "vocab", ...).  A rule table maps each logical
axis to an ordered list of mesh-axis candidates.  ``logical_to_spec``
walks the candidates and picks the first mesh axis (or tuple of mesh axes)
that (a) exists in the mesh, (b) is not yet used by another dim of the
same tensor and (c) is larger than 1 and divides the dimension; if none
qualifies the dimension is replicated.  That absorbs the awkward
dimensions of the zoo (yi-34b's 56 heads on a 16-way model axis,
mamba2's 50280-token vocabulary) with no per-architecture case.

A spec is the port's own: a tuple with one entry per tensor dim, each
``None`` (replicated), a mesh axis name, or a tuple of axis names (their
sizes multiply), as jax's ``PartitionSpec`` holds them.  A mesh is
anything that names its axes and their sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``mesh.shape``) or a :class:`MeshShape`, which lets the derivation run
with no process group.  ``spec_to_placements`` turns a spec into DTensor
placements and ``local_shape`` gives one rank's block, in place of the
reference's ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.models.common import tree_map

# A candidate is a tuple of mesh axes combined (sizes multiplied) for one
# tensor dimension; a single name stands for a one-axis tuple.
Candidate = tuple[str, ...]
Spec = tuple


def _as_candidate(c) -> Candidate:
    if isinstance(c, str):
        return (c,)
    return tuple(c)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Ordered mapping: logical axis -> candidate mesh axes."""

    rules: Mapping[str, Sequence[Candidate]]

    def candidates(self, logical: str) -> Sequence[Candidate]:
        return [_as_candidate(c) for c in self.rules.get(logical, ())]

    def with_overrides(self, **overrides) -> "AxisRules":
        merged = dict(self.rules)
        for k, v in overrides.items():
            merged[k] = v
        return AxisRules(merged)


# Production rules for the (pod, data, model) / (data, model) meshes.
# Batch-like axes shard over the whole data-parallel extent; weight axes
# over the model (tensor-parallel) axis.  "users" is the paper's federation
# axis: the pod axis when there is one (one user per pod, the paper's
# 2-user topology), else the data axis.
DEFAULT_RULES = AxisRules(
    {
        # activations
        "batch": [("pod", "data"), ("data",), ("pod",)],
        "seq": [],  # no context parallelism in the baseline
        "embed_act": [],
        # parameters
        "vocab": [("model",)],
        "embed": [],  # embedding feature dim; fallback target for vocab
        "embed_alt": [("model",)],  # used when vocab cannot shard
        "heads": [("model",)],
        "kv_heads": [("model",)],
        "head_dim": [],
        "qkv": [("model",)],
        "ffn": [("model",)],
        "experts": [("model",)],
        "expert_ffn": [],
        "ssm_heads": [("model",)],
        "ssm_state": [],
        "conv_dim": [("model",)],
        "lru_dim": [("model",)],
        "kv_lora": [],
        "layers": [],  # the stacked layer axis never shards
        "users": [("pod",), ("data",)],
    }
)


# Pure data parallelism: batch over every mesh axis, weights replicated
# (small models, where tensor parallelism's activation all-reduces dwarf
# the gradient all-reduce).
DP_ONLY_RULES = AxisRules(
    {
        "batch": [("pod", "data", "model"), ("data", "model"), ("data",)],
        "users": [("pod",), ("data",)],
    }
)

# FSDP / ZeRO-3: batch over every axis; each weight sharded on its first
# dim that the whole (data, model) extent, or one of its axes, divides.
_FSDP_W = [("data", "model"), ("model",), ("data",)]
FSDP_RULES = AxisRules(
    {
        "batch": [("pod", "data", "model"), ("data", "model"), ("data",)],
        "vocab": _FSDP_W,
        "embed": _FSDP_W,
        "embed_alt": _FSDP_W,
        "heads": _FSDP_W,
        "kv_heads": _FSDP_W,
        "ffn": _FSDP_W,
        "experts": _FSDP_W,
        "expert_ffn": _FSDP_W,
        "ssm_heads": _FSDP_W,
        "conv_dim": _FSDP_W,
        "lru_dim": _FSDP_W,
        "kv_lora": _FSDP_W,
        "users": [("pod",), ("data",)],
    }
)

NAMED_RULES = {"default": DEFAULT_RULES, "dp_only": DP_ONLY_RULES,
               "fsdp": FSDP_RULES}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""

    names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        assert len(self.names) == len(self.sizes), (self.names, self.sizes)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(logical_axes: Sequence[str | None],
                    dim_sizes: Sequence[int], mesh,
                    rules: AxisRules = DEFAULT_RULES) -> Spec:
    """The spec of one tensor.  ``logical_axes`` has one entry per dim
    (None: replicated).  A mesh axis is used at most once per tensor."""
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for logical, dim in zip(logical_axes, dim_sizes):
        entry = None
        if logical is not None:
            for cand in rules.candidates(logical):
                if any(a in used or a not in sizes for a in cand):
                    continue
                total = 1
                for a in cand:
                    total *= sizes[a]
                if total > 0 and dim % total == 0 and total > 1:
                    entry = cand[0] if len(cand) == 1 else tuple(cand)
                    used.update(cand)
                    break
        entries.append(entry)
    return tuple(entries)


def param_specs(params, logical_tree, mesh, rules: AxisRules = DEFAULT_RULES):
    """A tree of tensors (or anything with ``.shape``) and the matching
    tree of logical-axes tuples -> the tree of specs."""
    return tree_map(lambda arr, logical: logical_to_spec(
        logical, arr.shape, mesh, rules), params, logical_tree)


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim whose axis appears in entry ``i``, ``Replicate()`` on every
    other.  A tuple entry shards one tensor dim over several mesh dims,
    major to minor in the order it lists them; that is DTensor's order
    only when it lists them in mesh order, which every candidate of the
    rule tables does (asserted)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        assert pos == sorted(pos), (
            f"spec entry {entry!r} lists its mesh axes out of mesh order "
            f"{tuple(names)}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


def local_shape(global_shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """One rank's block of a tensor of ``global_shape`` under ``spec``:
    each sharded dim divided by the product of its axes' sizes (the rules
    only shard a dim its axes divide)."""
    sizes = mesh_axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    out = []
    for dim, entry in zip(global_shape, spec):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry!r} "
                             f"({n} ranks)")
        out.append(dim // n)
    return tuple(out)
