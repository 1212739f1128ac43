"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed
top-6, fine-grained [arXiv:2405.04434].

27L d_model=2048 16H d_ff(per expert)=1408 vocab=102400.
NOTE: the assignment bracket says "160 routed" while its structured field
says "MoE 64e top-6"; the released DeepSeek-V2-Lite has 64 routed experts,
so we follow the structured field (64).  Recorded in DESIGN.md.
MLA: kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
v_head_dim=128 (no q compression in the Lite release).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,              # nope(128) + rope(64)
    d_ff=10944,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
)
