"""seamless-m4t-large-v2 [audio] -- enc-dec, 24L(+24L enc) d_model=1024
16H (MHA kv=16) d_ff=8192 vocab=256206.  The audio frontend is a STUB:
input_specs provides precomputed frame embeddings.  [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, enc_layers=24, is_encdec=True,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    attention="full",
    norm="layernorm", act="gelu_plain",
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    num_layers=2, enc_layers=2, is_encdec=True,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=499,
    attention="full",
    norm="layernorm", act="gelu_plain", remat=False,
)
