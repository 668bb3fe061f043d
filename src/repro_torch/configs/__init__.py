"""Architecture registry of the port: the architectures it can build.

`get_config(name)` / `get_smoke_config(name)` behave as in
`repro.configs`, restricted to the paper's own Tier-A models."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES

_ARCHS = {
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
    return mod.CONFIG_MNIST


def get_smoke_config(name: str) -> ModelConfig:
    return get_config(name)  # the Tier-A models are already tiny


def list_archs():
    return list(_ARCHS)
