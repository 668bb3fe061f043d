"""minitron-8b [dense] -- 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000, pruned nemotron (squared-ReLU plain MLP, LayerNorm).
[arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    attention="full",
    norm="layernorm", act="relu2",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=997,
    attention="full",
    norm="layernorm", act="relu2", remat=False,
)
