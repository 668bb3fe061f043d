"""falcon-mamba-7b [ssm] -- 64L d_model=4096 attention-free vocab=65024,
mamba-1 architecture with ssm_state=16.  [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_expand=2, conv_width=4,
    norm="rmsnorm", act="silu",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=499,
    ssm_state=4, ssm_expand=2, conv_width=4,
    norm="rmsnorm", act="silu", remat=False,
)
