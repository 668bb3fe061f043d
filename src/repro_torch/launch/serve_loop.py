"""Continuous-batching serve loop over a CONTIGUOUS cache, port of
`repro.launch.serve_loop.ServeLoop`.

A fixed pool of B slots shares one batched KV cache sized B x max_len;
requests join mid-flight (a prefill of the request alone, written into a
free slot), one batched decode step runs for ALL slots each tick with
per-slot positions, and finished slots are recycled.  Greedy decode is
token-identical to serving each request alone (tests/test_torch_serve.py).
It serves the dense family and the SSM (falcon-mamba), whose per-slot
conv windows and states are written into the batched cache the same way;
the hybrid (recurrentgemma) is served on the fixed-batch path only, as the
reference's loop cannot serve its nested cache.

The reference's layout/mesh plumbing (`mesh=`, `layout=`, the policy's
cache-spec choice) belongs to the planning layer and waits for it; the
block-table `PagedServeLoop` waits for the paged slice (core/paging).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class _ServeBase:
    """Queue discipline and per-slot host state."""

    def __init__(self, model, params, *, max_batch: int):
        self.model = model
        self.params = params
        self.B = max_batch
        self.device = leaves(params)[0].device
        self.live: dict[int, Request] = {}   # slot -> request
        self.free = list(range(max_batch))
        self.queue: list[Request] = []
        # host-side truth for per-slot positions.  int32, NOT int64: the
        # device positions are int32, and an int64 host array would wrap
        # silently on the cast once lengths cross 2^31 (the reference's
        # regression, pinned in tests/test_serve_loop.py)
        self.lengths = np.zeros(max_batch, np.int32)
        self._next = torch.zeros(max_batch, dtype=torch.int32,
                                 device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    def run_until_drained(self, max_ticks: int = 10_000):
        done = []
        for _ in range(max_ticks):
            done += self.tick()
            if not self.live and not self.queue:
                break
        return done


class ServeLoop(_ServeBase):
    """Contiguous per-slot cache (see module docstring).  `cache_spec`
    ("layout[:shards]/dtype", models/cache.py) forces the KV-cache spec;
    None keeps the config's own."""

    def __init__(self, model, params, *, max_batch: int = 4,
                 max_len: int = 512, cache_spec: str | None = None):
        if model.cfg.family == "hybrid":
            raise NotImplementedError(
                f"{model.cfg.name}: the hybrid family's nested cache is "
                "served on the fixed-batch path (launch/serve.py); the "
                "reference's ServeLoop cannot serve it either")
        super().__init__(model, params, max_batch=max_batch)
        if cache_spec and model.supports_cache_spec \
                and cache_spec != model.cfg.cache_spec:
            from repro_torch.models import build_model
            model = build_model(
                dataclasses.replace(model.cfg, cache_spec=cache_spec))
            self.model = model    # params are spec-independent
        self.cache_spec = cache_spec
        self.S = max_len
        self.cache = tree_map(
            lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                  device=self.device),
            model.cache_defs(max_batch, max_len))
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)
        self.decode_steps = 0     # batched decode steps run so far

    # -- slot management -------------------------------------------------
    def _admit(self):
        while self.queue and self.free:
            req = self.queue.pop(0)
            slot = self.free.pop(0)
            T = len(req.prompt)
            assert T < self.S, "prompt exceeds slot capacity"
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                   device=self.device)
            nxt, pcache = self._prefill(self.params, {"tokens": toks})
            self._write_slot(slot, pcache, T)
            self._next[slot] = nxt[0]
            self.lengths[slot] = T
            req.out.append(int(nxt[0]))
            self.live[slot] = req

    def _write_slot(self, slot: int, pcache, true_len: int):
        """Copy a single-sequence prefill cache (leaves (L, 1, ...)) into
        the batched cache (leaves (L, B, ...)) at `slot`, in place.  Leaves
        of the slot's own shape are copied whole: the SSM's conv windows
        (L, B, w-1, di), which a prefill always fills (left-padded), and
        states (L, B, di, N).  K/V leaves have a time axis, padded with
        zeros or cropped to the slot capacity."""
        for key, bc in self.cache.items():
            pc = pcache[key]
            if key == "len":                              # (L, B) lengths
                bc[:, slot] = pc[:, 0].clamp(max=true_len)
                continue
            if pc.shape[2:] == bc.shape[2:]:
                bc[:, slot] = pc[:, 0].to(bc.dtype)
                continue
            width = min(pc.shape[2], bc.shape[2])
            bc[:, slot, :width] = pc[:, 0, :width].to(bc.dtype)
            bc[:, slot, width:] = 0

    # -- main tick --------------------------------------------------------
    def tick(self) -> list[Request]:
        """Admit waiting requests, run ONE batched decode step, return the
        requests that finished this tick."""
        self._admit()
        if not self.live:
            return []
        positions = torch.as_tensor(self.lengths.reshape(self.B, 1),
                                    device=self.device)
        nxt, self.cache = self._decode(
            self.params,
            {"tokens": self._next[:, None], "positions": positions},
            self.cache)
        self.decode_steps += 1
        self._next = nxt.to(torch.int32)
        nxt_host = nxt.cpu().numpy()
        finished = []
        for slot, req in list(self.live.items()):
            self.lengths[slot] += 1
            req.out.append(int(nxt_host[slot]))
            if len(req.out) >= req.max_new:
                req.done = True
                finished.append(req)
                del self.live[slot]
                self.free.append(slot)
        return finished
