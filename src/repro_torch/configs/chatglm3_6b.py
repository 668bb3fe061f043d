"""chatglm3-6b [dense] -- 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (partial) RoPE.  [arXiv:2406.12793; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024,
    qkv_bias=True, attention="full", rope_fraction=0.5,
    norm="rmsnorm", act="silu",
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=499,
    qkv_bias=True, attention="full", rope_fraction=0.5,
    norm="rmsnorm", act="silu", remat=False,
)
