"""Unified model interface: one `Model` object per architecture config.

Model exposes, as `repro.models.Model` does for the families ported so far
(cnn, mlp):
  param_defs()                     -> dict tree of ParamDef
  init(key, device)                -> concrete params on `device`
  apply(params, batch, mode, cache) -> (logits, aux)
  n_params                         -> int
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.models import cnn
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import count_params, init_params
from repro_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    _defs: Callable
    _apply: Callable

    def param_defs(self):
        return self._defs(self.cfg)

    def init(self, key: np.ndarray, device="cuda"):
        """`key`: a Threefry key (`repro_torch.threefry.key(seed)`)."""
        return init_params(key, self.param_defs(), resolve_device(device))

    def apply(self, params, batch, *, mode="train", cache=None):
        return self._apply(params, self.cfg, batch, mode=mode, cache=cache)

    @property
    def n_params(self) -> int:
        return count_params(self.param_defs())


_FAMILY = {
    "cnn": (cnn.cnn_defs, cnn.cnn_apply),
    "mlp": (cnn.mlp_classifier_defs, cnn.mlp_classifier_apply),
}


def build_model(cfg: ModelConfig) -> Model:
    fam = "mlp" if (cfg.family == "cnn" and not cfg.cnn_channels
                    and cfg.d_model) else cfg.family
    if fam not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' is not ported yet "
            f"(have {sorted(_FAMILY)})")
    defs, apply = _FAMILY[fam]
    return Model(cfg, defs, apply)
