"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427 (Griffin)].

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000,
local-attention window 2048, lru_width 4096.
38 = 12 full (rec, rec, attn) groups + 2 trailing recurrent layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma-9B)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("recurrent", "recurrent", "attention"),
    window=2048,
    lru_width=4096,
    act="gelu",
    tie_embeddings=True,
    logit_softcap=30.0,
)
