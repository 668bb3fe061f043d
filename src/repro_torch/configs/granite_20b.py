"""granite-20b [dense] -- 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, code model.  [arXiv:2405.04324; hf]

d_ff = 4*d_model with MQA indicates a plain (non-gated) MLP, gpt-bigcode
style; we keep RoPE+RMSNorm per the 'llama-arch' note in the assignment."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    attention="full",
    norm="rmsnorm", act="gelu_plain",
    grad_accum=16,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=499,
    attention="full",
    norm="rmsnorm", act="gelu_plain", remat=False,
)
