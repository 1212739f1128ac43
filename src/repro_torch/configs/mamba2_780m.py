"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="arXiv:2405.21060 (Mamba-2 SSD); mamba2-780m release dims",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_n_groups=1,
    conv_width=4,
    chunk_size=256,
    tie_embeddings=True,
)
