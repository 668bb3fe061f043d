"""Architecture registry of the port: the architectures it can build.

`get_config(name)` / `get_smoke_config(name)` behave as in
`repro.configs`: the paper's own Tier-A models, the dense LMs, the MoE
LMs, the recurrent LMs (ssm, hybrid), the VLM stub (phi-3-vision) and the
audio encoder-decoder (seamless-m4t)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES

_ARCHS = {   # the reference's order (its sweeps and check-fit lines)
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen1.5-4b": "qwen1_5_4b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-20b": "granite_20b",
    "minitron-8b": "minitron_8b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's own workloads (Tier-A FL experiments)
    "flight-cnn-mnist": "flight_cnn",
    "flight-cnn-cifar": "flight_cnn",
}


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str) -> ModelConfig:
    mod = _module(name)
    if name == "flight-cnn-cifar":
        return mod.CONFIG_CIFAR
    if name == "flight-cnn-mnist":
        return mod.CONFIG_MNIST
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = _module(name)
    if name.startswith("flight-cnn"):
        return get_config(name)  # already tiny
    return mod.SMOKE


def list_archs(assigned_only: bool = False):
    """Every arch the port builds; `assigned_only` leaves out the paper's
    own flight CNNs, as the reference's default does."""
    if assigned_only:
        return [n for n in _ARCHS if not n.startswith("flight-")]
    return list(_ARCHS)
