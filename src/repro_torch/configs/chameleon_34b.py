"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, QK-norm.
Early fusion means VQ image tokens share the text vocab: the backbone
consumes one mixed token stream; the VQ-GAN tokenizer is the stubbed
frontend (input_specs supplies the token ids directly).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818 (Chameleon-34B)",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    modality="vlm",
)
