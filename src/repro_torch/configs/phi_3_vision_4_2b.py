"""phi-3-vision-4.2b [vlm] -- 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064, phi3-mini backbone + CLIP frontend (STUB: input_specs provides
576 precomputed patch embeddings occupying the sequence prefix).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    attention="full",
    frontend="vision_stub", frontend_len=576,
    norm="rmsnorm", act="silu",
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=499,
    attention="full",
    frontend="vision_stub", frontend_len=8,
    norm="rmsnorm", act="silu", remat=False,
)
