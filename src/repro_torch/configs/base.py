"""Config system: dataclass model/run configs + a registry (a copy of the
reference's ``configs/base.py``; it holds no JAX).  ``get_config`` imports
``repro_torch.configs.<id>`` from a string, never the reference's module.

Every assigned architecture lives in its own ``configs/<id>.py`` exposing
``CONFIG`` (the exact published dims, cited) and registering itself.  Each
config can produce a ``reduced()`` smoke variant (<=2 layers, d_model<=512,
<=4 experts) that runs a real forward/train step on CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""  # citation (arXiv id / model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- MoE ---
    num_experts: int = 0          # routed experts
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0             # per-expert hidden width (fine-grained)
    first_dense_layers: int = 0   # leading layers that use a dense FFN
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 0   # >0: GShard-style grouped dispatch — tokens are
                          # routed within groups aligned to the data axis,
                          # so the dispatch sort never crosses shards

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256

    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("recurrent","recurrent","attention")
    window: int = 0                      # local-attention window (0 = full)
    lru_width: int = 0

    # --- encoder-decoder (audio) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_downsample: int = 4   # audio frontend stub: frames = seq // this

    # --- misc ---
    qkv_bias: bool = False
    qk_norm: bool = False
    # --- perf variants (hillclimbing levers; see EXPERIMENTS.md §Perf) ---
    pad_heads_multiple: int = 0   # pad q-heads up so they shard (yi: 56->64)
    attn_impl: str = "dense"      # dense | blockwise (online-softmax scan)
    attn_block: int = 512         # kv block for blockwise impl
    grad_sync_dtype: str = ""     # cast grads before DP sync ("bfloat16")
    seq_shard: bool = False       # Megatron-SP: residual stream sharded on
                                  # (seq -> model); GSPMD turns the per-layer
                                  # all-reduce into all-gather+reduce-scatter
    logits_dtype: str = "float32"  # serve-path logits precision lever
    zero1: bool = False            # ZeRO-1: shard f32 Adam moments over the
                                   # data axis (first divisible dim)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    act: str = "silu"             # silu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "none"           # none | full | offloadable-dots
    scan_layers: bool = True
    modality: str = "text"        # text | audio | vlm

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.use_mla and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.nope_head_dim or self.head_dim)

    # ---- derived quantities -------------------------------------------
    @property
    def padded_heads(self) -> int:
        """q-head count after padding (extra heads are zero-contribution:
        their w_o rows are zeroed, so the math is unchanged — they exist
        only so the head dim divides the model axis)."""
        if not self.pad_heads_multiple:
            return self.num_heads
        m = self.pad_heads_multiple
        return ((self.num_heads + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attends(self) -> bool:
        return self.arch_type != "ssm"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (2 layers, d_model<=512,
        <=4 experts), runnable on CPU."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) or 0
        kv = min(self.num_kv_heads, heads) if self.num_kv_heads else 0
        if kv and heads % kv:
            kv = 1
        pattern = self.block_pattern[:3] if self.block_pattern else ()
        n_layers = len(pattern) if pattern else 2
        changes = dict(
            num_layers=n_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d_model // heads) if heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 128),
            first_dense_layers=min(self.first_dense_layers, 1),
            first_dense_d_ff=min(self.first_dense_d_ff, 256),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            q_lora_rank=min(self.q_lora_rank, 64),
            rope_head_dim=min(self.rope_head_dim, 16) if self.rope_head_dim else 0,
            nope_head_dim=(d_model // heads - min(self.rope_head_dim, 16))
            if self.use_mla and heads else self.nope_head_dim,
            v_head_dim=(d_model // heads) if (self.use_mla and heads) else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32),
            chunk_size=32,
            window=min(self.window, 32) if self.window else 0,
            lru_width=min(self.lru_width, 256) if self.lru_width else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            block_pattern=pattern,
            param_dtype="float32",
            compute_dtype="float32",
        )
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS: Sequence[str] = (
    "mamba2_780m",
    "seamless_m4t_medium",
    "recurrentgemma_9b",
    "deepseek_moe_16b",
    "stablelm_1_6b",
    "tinyllama_1_1b",
    "yi_34b",
    "qwen2_72b",
    "chameleon_34b",
    "deepseek_v2_lite_16b",
)

# canonical public ids (with dashes) -> module names
_ALIASES = {
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "stablelm-1.6b": "stablelm_1_6b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "yi-34b": "yi_34b",
    "qwen2-72b": "qwen2_72b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
