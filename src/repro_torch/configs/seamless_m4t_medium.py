"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

12L (per stack) d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.
The mel-spectrogram + conv feature-extractor frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, S//4, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    source="arXiv:2308.11596 (SeamlessM4T medium)",
    num_layers=12,             # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    act="gelu",
    norm="layernorm",
    modality="audio",
    encoder_downsample=4,
)
