"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=102400;
layer 0 uses a dense FFN (d_ff 10944) per the release.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,               # dense layers' width
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,
)
