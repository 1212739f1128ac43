"""Three-term roofline of one step on one H100 (port of the reference's
``roofline/analysis.py``):

  compute    = FLOPs / (chips * peak FLOP/s)
  memory     = bytes / (chips * HBM bytes/s)
  collective = collective bytes / (chips * link bytes/s)

``cost_analysis(fn, *args)`` is the counterpart of the compiled
artifact's ``cost_analysis()``: it runs ``fn`` once and counts the FLOPs
of its aten ops with ``torch.utils.flop_counter.FlopCounterMode`` and
their bytes as each op's operands plus its outputs (views move nothing),
the per-op count XLA reports as "bytes accessed".  Nothing fuses in eager
torch, so the port's count is the unfused one: every intermediate is
written and read back.  Collective bytes come from the records of
``core.collectives.record_collectives()`` (kind, result shape, dtype),
priced as the reference prices the collectives of a compiled program:
result bytes times a per-kind ring factor (all-reduce 2x: reduce-scatter
plus all-gather).

Rates, from one source (``repro_torch.timing``, the H100 SXM data
sheet): 989e12 bf16 FLOP/s and 3.35e12 B/s of HBM.  The link is NVLink
4, 900 GB/s aggregate per GPU, taken as 450e9 B/s in each direction: a
ring step sends and receives at once, so one direction's rate bounds it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.timing import BF16_OPS_PER_S, HBM_BYTES_PER_S

PEAK_FLOPS = BF16_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S
NVLINK_BW = 450e9          # one direction of NVLink 4's 900 GB/s
NVLINK_LINKS = 1.0         # the aggregate above is the GPU's whole fabric

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

# result-bytes multiplier approximating ring cost per chip
_OP_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "collective-broadcast": 1.0,
}


def collective_bytes(records) -> dict:
    """Per-kind and total per-device collective bytes of ``(kind, shape,
    dtype)`` records (``core.collectives.record_collectives``; ``dtype``
    an HLO element type name such as ``"f32"``): the reference's
    ``collective_bytes_from_hlo`` over the same collectives."""
    per_kind: dict[str, float] = {}
    for kind, shape, dtype in records:
        n = 1
        for d in shape:
            n *= int(d)
        b = n * _DTYPE_BYTES[dtype] * _OP_FACTOR[kind]
        per_kind[kind] = per_kind.get(kind, 0.0) + b
    per_kind["total"] = sum(v for k, v in per_kind.items() if k != "total")
    return per_kind


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """An op whose outputs alias an input without writing it (a view)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its work: ``{"flops":
    ..., "bytes accessed": ...}`` (the keys of the compiled artifact's
    ``cost_analysis()``), FLOPs by ``FlopCounterMode``, bytes as every
    non-view aten op's operands plus outputs, unfused."""
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes)}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per chip (the counted step's)
    hlo_bytes: float          # per chip
    collective_bytes: float   # per chip
    model_flops: float        # global (all chips)
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs, both per chip.  < 1 because a step
        also carries attention/norm/aux work; >> drops flag redundant
        compute (remat); << 1 flags missing parallelism."""
        return (self.model_flops / self.chips) / max(self.hlo_flops, 1.0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: dict, collective: dict, model_fl: float,
                   bytes_per_device: float) -> RooflineReport:
    """``cost``: ``cost_analysis``'s dict (a one-element list of it is
    taken too, as jax 0.4.x wraps it); ``collective``:
    ``collective_bytes``'s.  NOTE on conventions: the counted step is one
    card's, so ``flops`` and ``bytes accessed`` are per-chip numbers."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = float(collective.get("total", 0.0))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, collective_bytes=coll,
        model_flops=model_fl,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll / (NVLINK_LINKS * NVLINK_BW),
        bytes_per_device=bytes_per_device,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode: 2 N per token
# ---------------------------------------------------------------------------

def param_count(cfg, *, active_only: bool = False) -> float:
    """Analytic parameter count for the assigned configs."""
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    n = V * d  # embedding
    if not cfg.tie_embeddings:
        n += d * V

    def attn_params():
        if cfg.use_mla:
            qk_hd = cfg.nope_head_dim + cfg.rope_head_dim
            return (d * cfg.num_heads * qk_hd + d * cfg.kv_lora_rank +
                    d * cfg.rope_head_dim +
                    cfg.kv_lora_rank * cfg.num_heads *
                    (cfg.nope_head_dim + cfg.v_head_dim) +
                    cfg.num_heads * cfg.v_head_dim * d)
        hd = cfg.head_dim
        return d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)

    def mlp_params(ff):
        return 3 * d * ff

    at = cfg.arch_type
    if at == "ssm":
        di, H = cfg.d_inner, cfg.ssm_heads
        GN = cfg.ssm_n_groups * cfg.ssm_state
        per = (2 * d * di + 2 * d * GN + d * H + di * d +
               cfg.conv_width * (di + 2 * GN))
        n += L * per
    elif at == "hybrid":
        period = len(cfg.block_pattern)
        n_attn = (L // period) * sum(
            1 for b in cfg.block_pattern if b == "attention")
        n_rec = L - n_attn
        r = cfg.lru_width
        rec_per = 2 * d * r + 2 * r * r + r * d + cfg.conv_width * r
        n += n_attn * (attn_params() + mlp_params(cfg.d_ff))
        n += n_rec * (rec_per + mlp_params(cfg.d_ff))
    elif at == "moe":
        nd = cfg.first_dense_layers
        moe_per = (cfg.num_experts * 3 * d * cfg.moe_d_ff +
                   cfg.num_shared_experts * 3 * d * cfg.moe_d_ff +
                   d * cfg.num_experts)
        active_per = ((cfg.experts_per_token + cfg.num_shared_experts) *
                      3 * d * cfg.moe_d_ff + d * cfg.num_experts)
        ff_term = active_per if active_only else moe_per
        n += nd * (attn_params() + mlp_params(cfg.first_dense_d_ff or cfg.d_ff))
        n += (L - nd) * (attn_params() + ff_term)
    elif at == "audio":
        n += cfg.num_encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        # decoder: self-attn + cross-attn + mlp
        n += L * (2 * attn_params() + mlp_params(cfg.d_ff))
    else:  # dense / vlm
        n += L * (attn_params() + mlp_params(cfg.d_ff))
    return float(n)


def model_flops(cfg, shape_cfg) -> float:
    """6*N*D for train, 2*N*D for prefill (fwd only), 2*N per decoded
    token; MoE uses active params."""
    n_active = param_count(cfg, active_only=True)
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape_cfg.global_batch
