"""recurrentgemma-9b [hybrid] -- 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention in a 2:1 pattern (Griffin).
[arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    attention="local", window=2048,
    lru_width=4096, conv_width=4,
    pattern_recurrent=2, pattern_attention=1,
    norm="rmsnorm", act="gelu",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=499,
    attention="local", window=8,
    lru_width=64, conv_width=4,
    pattern_recurrent=2, pattern_attention=1,
    norm="rmsnorm", act="gelu", remat=False,
)
