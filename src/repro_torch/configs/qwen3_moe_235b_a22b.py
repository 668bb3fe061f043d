"""qwen3-moe-235b-a22b [moe] -- 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B family scaling; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=64,
    d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    attention="full",
    norm="rmsnorm", act="silu", rope_theta=1e6,
    grad_accum=16,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=96, vocab_size=499,
    num_experts=8, experts_per_token=4, moe_d_ff=96,
    capacity_factor=0.0,  # dropless: decode must match teacher forcing
    attention="full",
    norm="rmsnorm", act="silu", remat=False,
)
