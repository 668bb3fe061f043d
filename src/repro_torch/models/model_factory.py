"""Unified model interface: one `Model` object per architecture config.

Model exposes, as `repro.models.Model` does for the families ported so far
(cnn, mlp, dense, moe, ssm, hybrid):
  param_defs()                      -> dict tree of ParamDef
  init(key, device)                 -> concrete params on `device`
  apply(params, batch, mode, cache) -> (logits, aux_or_cache)
  cache_defs(batch, seq)            -> dict tree of ParamDef (decode cache)
  paged_cache_defs(batch, num_blocks, block_size, max_blocks_per_seq)
                                    -> the block-pool cache (dense, MoE)
  n_params / n_active_params        -> int
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.models import cnn, rglru, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import count_params, init_params
from repro_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    _defs: Callable
    _apply: Callable
    _cache_defs: Optional[Callable] = None

    def param_defs(self):
        return self._defs(self.cfg)

    def init(self, key: np.ndarray, device="cuda"):
        """`key`: a Threefry key (`repro_torch.threefry.key(seed)`)."""
        return init_params(key, self.param_defs(), resolve_device(device))

    def apply(self, params, batch, *, mode="train", cache=None, **kw):
        """`kw`: `impl="auto"|"ref"` for the LM's kernel ops."""
        return self._apply(params, self.cfg, batch, mode=mode, cache=cache,
                           **kw)

    @property
    def supports_cache_spec(self) -> bool:
        """CacheSpec layouts (ring / int8) apply to growing KV caches."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def cache_defs(self, batch: int, seq_len: int, spec=None):
        """Decode-cache defs; `spec` (a models/cache.CacheSpec or its
        string form) overrides the config's cache_spec."""
        if self._cache_defs is None:
            raise ValueError(f"{self.cfg.name}: no decode cache (family="
                             f"{self.cfg.family})")
        if spec is not None and self.supports_cache_spec:
            return self._cache_defs(self.cfg, batch, seq_len, spec=spec)
        return self._cache_defs(self.cfg, batch, seq_len)

    @property
    def supports_paged_cache(self) -> bool:
        """Block-table paging applies to growing KV caches (transformer
        families); SSM / RG-LRU state is O(1) per sequence, so those keep
        the contiguous path."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def paged_cache_defs(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks_per_seq: int):
        if not self.supports_paged_cache:
            raise ValueError(f"{self.cfg.name}: paged KV cache unsupported "
                             f"(family={self.cfg.family})")
        return transformer.paged_cache_defs(
            self.cfg, batch, num_blocks, block_size, max_blocks_per_seq)

    @property
    def n_params(self) -> int:
        return count_params(self.param_defs())

    @property
    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: only k of E experts count)."""
        cfg = self.cfg
        if not cfg.num_experts:
            return self.n_params
        defs = self.param_defs()
        total = count_params(defs)
        moe = defs["layers"].get("moe")
        if moe is None:
            return total
        expert_total = sum(int(np.prod(moe[name].shape))
                           for name in ("w_gate", "w_up", "w_down"))
        active = expert_total * cfg.experts_per_token / cfg.num_experts
        return int(total - expert_total + active)


_FAMILY = {
    "dense": (transformer.lm_defs, transformer.lm_apply,
              transformer.cache_defs),
    "moe": (transformer.lm_defs, transformer.lm_apply,
            transformer.cache_defs),
    "ssm": (ssm.ssm_lm_defs, ssm.ssm_lm_apply, ssm.ssm_cache_defs),
    "hybrid": (rglru.hybrid_lm_defs, rglru.hybrid_lm_apply,
               rglru.hybrid_cache_defs),
    "cnn": (cnn.cnn_defs, cnn.cnn_apply, None),
    "mlp": (cnn.mlp_classifier_defs, cnn.mlp_classifier_apply, None),
}


def build_model(cfg: ModelConfig) -> Model:
    fam = "mlp" if (cfg.family == "cnn" and not cfg.cnn_channels
                    and cfg.d_model) else cfg.family
    if fam not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' is not ported yet "
            f"(have {sorted(_FAMILY)})")
    return Model(cfg, *_FAMILY[fam])
