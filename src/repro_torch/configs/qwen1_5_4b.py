"""qwen1.5-4b [dense] -- 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-4B family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, attention="full",
    norm="rmsnorm", act="silu",
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=12,
    d_ff=128, vocab_size=499,
    qkv_bias=True, attention="full",
    norm="rmsnorm", act="silu", remat=False,
)
