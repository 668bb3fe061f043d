"""Unified model interface: one `Model` object per architecture config.

Model exposes, as `repro.models.Model` does, for every family (cnn, mlp,
dense, moe, vlm, ssm, hybrid, audio):
  param_defs()                      -> dict tree of ParamDef
  init(key, device)                 -> concrete params on `device`
  apply(params, batch, mode, cache) -> (logits, aux_or_cache)
  cache_defs(batch, seq)            -> dict tree of ParamDef (decode cache)
  paged_cache_defs(batch, num_blocks, block_size, max_blocks_per_seq)
                                    -> the block-pool cache (dense, MoE,
                                       VLM)
  input_defs(shape)                 -> dict of ParamDef, one per input
  n_params / n_active_params        -> int
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models import cnn, encdec, rglru, ssm, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.param import count_params, init_params, pdef
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
        """CacheSpec layouts (ring / int8) apply to growing KV caches;
        SSM / RG-LRU state and the enc-dec cross cache keep their own
        conventions."""
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
        families); SSM / RG-LRU state is O(1) per sequence and the enc-dec
        cross cache is static, so those keep the contiguous path."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def paged_cache_defs(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks_per_seq: int):
        if not self.supports_paged_cache:
            raise ValueError(f"{self.cfg.name}: paged KV cache unsupported "
                             f"(family={self.cfg.family})")
        return transformer.paged_cache_defs(
            self.cfg, batch, num_blocks, block_size, max_blocks_per_seq)

    def input_defs(self, shape: ShapeConfig):
        """Every input of a step at `shape`: the one place where the
        shapes and dtypes of `patch_embeds` and `frames` are written."""
        cfg = self.cfg
        B = shape.global_batch
        if cfg.family == "cnn":
            return {
                "images": pdef((B, cfg.img_hw, cfg.img_hw, cfg.img_c),
                               ("batch", None, None, None),
                               dtype=torch.float32),
                "labels": pdef((B,), ("batch",), dtype=torch.int32),
            }
        T = 1 if shape.kind == "decode" else shape.seq_len
        d: dict[str, Any] = {
            "tokens": pdef((B, T), ("batch", None), dtype=torch.int32),
        }
        if shape.kind == "train":
            d["labels"] = pdef((B, T), ("batch", None), dtype=torch.int32)
        if cfg.frontend == "vision_stub" and shape.kind != "decode":
            d["patch_embeds"] = pdef((B, cfg.frontend_len, cfg.d_model),
                                     ("batch", None, None))
        if cfg.is_encdec and shape.kind != "decode":
            el = encdec.enc_len_for(shape.seq_len)
            d["frames"] = pdef((B, el, cfg.d_model), ("batch", None, None))
        if shape.kind == "decode":
            d["positions"] = pdef((B, 1), ("batch", None), dtype=torch.int32)
        return d

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
    "vlm": (transformer.lm_defs, transformer.lm_apply,
            transformer.cache_defs),
    "ssm": (ssm.ssm_lm_defs, ssm.ssm_lm_apply, ssm.ssm_cache_defs),
    "hybrid": (rglru.hybrid_lm_defs, rglru.hybrid_lm_apply,
               rglru.hybrid_cache_defs),
    "audio": (encdec.encdec_defs, encdec.encdec_apply,
              encdec.encdec_cache_defs),
    "cnn": (cnn.cnn_defs, cnn.cnn_apply, None),
    "mlp": (cnn.mlp_classifier_defs, cnn.mlp_classifier_apply, None),
}


def build_model(cfg: ModelConfig) -> Model:
    fam = "mlp" if (cfg.family == "cnn" and not cfg.cnn_channels
                    and cfg.d_model) else cfg.family
    if fam not in _FAMILY:
        raise ValueError(f"{cfg.name}: unknown family '{cfg.family}' "
                         f"(have {sorted(_FAMILY)})")
    return Model(cfg, *_FAMILY[fam])
