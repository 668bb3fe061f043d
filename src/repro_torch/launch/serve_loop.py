"""Continuous-batching serve loops, port of `repro.launch.serve_loop`.

Two cache disciplines behind one Request/submit/tick API:

* ``ServeLoop`` -- the CONTIGUOUS cache: a fixed pool of B slots shares
  one batched KV cache sized B x max_len; requests join mid-flight (a
  prefill of the request alone, written into a free slot), one batched
  decode step runs for ALL slots each tick with per-slot positions, and
  finished slots are recycled.  Greedy decode is token-identical to
  serving each request alone (tests/test_torch_serve.py).  It serves the
  dense, MoE and VLM families (text prompts: the reference's loops pass
  tokens only) and the SSM (falcon-mamba), whose per-slot conv windows
  and states are written into the batched cache the same way.  The
  hybrid (recurrentgemma) and the enc-dec (seamless-m4t) are served on
  the fixed-batch path only, as the reference's loop cannot serve them:
  it cannot write the hybrid's nested cache, and its prefill passes no
  `frames`, which the enc-dec's encoder needs.

* ``PagedServeLoop`` -- the BLOCK-TABLE PAGED cache (dense, MoE and VLM
  LMs without a sliding window: a windowed layer raises ValueError): one KV
  block pool shared by all slots (core/paging.py: free list, refcounts,
  prefix sharing), per-slot block tables mapping position -> (block,
  offset), block-aligned chunked prefill whose tail pads to a power-of-two
  bucket, lazy block growth during decode, and preemption (requeue the
  youngest sequence) when the pool runs dry.  Only the pool lives on the
  device between ticks; tables and lengths are rebuilt from host state
  every step.  Its prefill attention is the reference's plain route
  (layers.paged_chunk_attention, P rounded to bf16), the contiguous
  prefill's the flash_attention kernel (P in fp32), so the two loops'
  greedy streams agree except where the two best logits nearly tie
  (tests/test_torch_paged.py).

Both loops take the reference's `mesh=` / `layout=`: with `mesh=` (an
AbstractMesh or a DeviceMesh; launch/mesh.make_host_mesh() for the cards
this process sees) and `layout="auto"` the memory-aware policy
(dist/policy.py) scores the (weight layout x cache spec) product for the
loop's shape, kept in `layout_decision`, and ServeLoop's
`cache_spec=None` defers to the decision's cache spec; `layout=<name>`
forces a layout.  The chosen rules and the mesh are ambient
(dist/sharding.use_rules / use_mesh) while a step runs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core.paging import BlockAllocator, OutOfBlocks
from repro_torch.launch.steps import (make_chunk_prefill_step,
                                      make_decode_step, make_prefill_step)
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class _ServeBase:
    """Layout/mesh plumbing, queue discipline and per-slot host state."""

    def __init__(self, model, params, *, max_batch: int, mesh=None,
                 layout: str = "auto", shape=None):
        self.model = model
        self.params = params
        self.B = max_batch
        self.layout_decision = None
        self.rules = None
        self.mesh = mesh
        if layout != "auto":
            from repro_torch.dist.sharding import serve_layout_rules
            self.rules = serve_layout_rules(layout)
        elif mesh is not None:
            from repro_torch.dist import policy as dist_policy
            self.layout_decision = dist_policy.analytic_serve_decision(
                model, shape, mesh)
            self.rules = self.layout_decision.rules
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

    def _rules_ctx(self):
        """The chosen layout's rules and the mesh, ambient while a step
        runs (a plain context with neither)."""
        stack = contextlib.ExitStack()
        if self.rules is not None:
            from repro_torch.dist.sharding import use_rules
            stack.enter_context(use_rules(self.rules))
        if self.mesh is not None:
            from repro_torch.dist.sharding import use_mesh
            stack.enter_context(use_mesh(self.mesh))
        return stack

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
    None defers to the layout policy's decision (when mesh= was given),
    else keeps the config's own."""

    def __init__(self, model, params, *, max_batch: int = 4,
                 max_len: int = 512, mesh=None, layout: str = "auto",
                 cache_spec: str | None = None):
        if model.cfg.family == "hybrid":
            raise NotImplementedError(
                f"{model.cfg.name}: the hybrid family's nested cache is "
                "served on the fixed-batch path (launch/serve.py); the "
                "reference's ServeLoop cannot serve it either")
        if model.cfg.is_encdec:
            raise NotImplementedError(
                f"{model.cfg.name}: the enc-dec is served on the fixed-batch "
                "path (launch/serve.py); the reference's ServeLoop cannot "
                "serve it either (its prefill passes no frames)")
        from repro_torch.models.config import ShapeConfig
        super().__init__(model, params, max_batch=max_batch, mesh=mesh,
                         layout=layout,
                         shape=ShapeConfig("serve", "decode", max_len,
                                           max_batch))
        spec = cache_spec
        if spec is None and self.layout_decision is not None:
            spec = self.layout_decision.cache_spec or None
        if spec and model.supports_cache_spec \
                and spec != model.cfg.cache_spec:
            from repro_torch.models import build_model
            model = build_model(
                dataclasses.replace(model.cfg, cache_spec=spec))
            self.model = model    # params are spec-independent
        self.cache_spec = spec
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
            with self._rules_ctx():
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
        with self._rules_ctx():
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


def _bucket(n: int) -> int:
    """Next power of two >= n: a tail prefill chunk pads to a bucket, so
    the chunk shapes stay O(log chunk) in number."""
    b = 1
    while b < n:
        b *= 2
    return b


class PagedServeLoop(_ServeBase):
    """Block-table paged KV cache + chunked/bucketed prefill (see module
    docstring).  ``num_blocks * block_size`` cache positions are shared by
    up to ``max_batch`` concurrent sequences; the device pool holds one
    more block, the sink of dropped writes (layers.paged_kv_write)."""

    def __init__(self, model, params, *, max_batch: int = 4,
                 num_blocks: int = 64, block_size: int = 16,
                 chunk: int = 64, mesh=None, layout: str = "auto"):
        if not model.supports_paged_cache:
            raise ValueError(
                f"{model.cfg.name}: paged serving needs a growing KV cache "
                f"(family={model.cfg.family}); use ServeLoop")
        if chunk % block_size:
            raise ValueError(f"chunk {chunk} must be a multiple of the "
                             f"block size {block_size}")
        from repro_torch.models.config import ShapeConfig
        super().__init__(model, params, max_batch=max_batch, mesh=mesh,
                         layout=layout,
                         shape=ShapeConfig("serve", "decode",
                                           num_blocks * block_size,
                                           max_batch))
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.bs = block_size
        self.nbmax = num_blocks            # a table can never exceed the pool
        self.chunk = chunk
        defs = model.paged_cache_defs(max_batch, num_blocks, block_size,
                                      self.nbmax)
        # only the block pool lives on the device between ticks; tables
        # and lengths are rebuilt from host state every step
        self.pages = {k: torch.zeros(defs[k].shape, dtype=defs[k].dtype,
                                     device=self.device)
                      for k in ("kp", "vp")}
        self.bt = np.zeros((max_batch, self.nbmax), np.int32)
        self._seq_of_slot: dict[int, int] = {}
        self._admit_order: list[int] = []   # slots, oldest first
        self._seq_counter = 0
        self.preemptions = 0
        self._decode = make_decode_step(model)
        self._chunk_prefill = make_chunk_prefill_step(model)
        self.decode_steps = 0     # batched decode steps run so far
        self.chunk_steps = 0      # prefill chunks run so far

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- admission -------------------------------------------------------
    def _admit(self):
        while self.queue and self.free:
            req = self.queue[0]
            prompt = np.asarray(req.prompt, np.int32)
            T = len(prompt)
            if (T + 1 + self.bs - 1) // self.bs > self.alloc.num_blocks:
                raise RuntimeError(
                    f"prompt of {T} tokens can never fit the "
                    f"{self.alloc.num_blocks}x{self.bs} block pool")
            sid = self._seq_counter
            try:
                res = self.alloc.admit(sid, prompt.tolist(), reserve=1)
            except OutOfBlocks:
                if not self.live and not self._preempt_youngest(protect=-1):
                    raise RuntimeError(
                        "admission stalled with no live sequences: "
                        "block pool exhausted by the prefix cache?")
                return                     # head-of-line waits for blocks
            self._seq_counter += 1
            self.queue.pop(0)
            slot = self.free.pop(0)
            self._seq_of_slot[slot] = sid
            self._admit_order.append(slot)
            self._set_table(slot, res.table)
            nxt = self._prefill_chunks(slot, prompt, res.n_shared_tokens, T)
            self._next[slot] = nxt
            self.lengths[slot] = T
            req.out.append(nxt)
            self.live[slot] = req

    def _set_table(self, slot: int, table: list[int]):
        self.bt[slot] = 0
        self.bt[slot, : len(table)] = table

    def _prefill_chunks(self, slot: int, prompt: np.ndarray, start: int,
                        T: int) -> int:
        """Stream prompt positions [start, T) through the pool in
        block-aligned chunks; the tail pads to a power-of-two bucket
        (positions -1: writes dropped; logits taken at the last valid
        row).  `start` skips positions covered by shared prefix blocks,
        whose K/V is already resident.  -> the first generated token."""
        bt_row = self._tensor(self.bt[slot: slot + 1])
        pos = start
        nxt = None
        while pos < T:
            c = min(self.chunk, T - pos)
            cb = c if c == self.chunk else _bucket(c)
            toks = np.zeros((1, cb), np.int32)
            toks[0, :c] = prompt[pos: pos + c]
            pv = np.full((1, cb), -1, np.int32)
            pv[0, :c] = np.arange(pos, pos + c, dtype=np.int32)
            with self._rules_ctx():
                nxt, self.pages = self._chunk_prefill(
                    self.params, {"tokens": self._tensor(toks),
                                  "positions": self._tensor(pv),
                                  "block_tables": bt_row,
                                  "last_index": self._tensor(
                                      np.array([c - 1], np.int32))},
                    self.pages)
            self.chunk_steps += 1
            pos += c
        return int(nxt[0])

    # -- eviction / preemption -------------------------------------------
    def _release(self, slot: int):
        self.alloc.finish(self._seq_of_slot.pop(slot))
        self._admit_order.remove(slot)
        self.bt[slot] = 0
        self.lengths[slot] = 0
        self.free.append(slot)

    def _preempt_youngest(self, protect: int) -> bool:
        """Requeue the most recently admitted live sequence (other than
        `protect`) at the FRONT of the queue, releasing its blocks.
        Greedy decode is deterministic, so re-running it from the prompt
        reproduces the same tokens."""
        for slot in reversed(self._admit_order):
            if slot == protect or slot not in self.live:
                continue
            req = self.live.pop(slot)
            req.out = []
            self.queue.insert(0, req)
            self._release(slot)
            self.preemptions += 1
            return True
        return False

    def _grow_tables(self):
        """Give every live slot a block for the position it writes this
        tick, preempting the youngest sequences when the pool is dry."""
        for slot in list(self.live):
            if slot not in self.live:
                continue
            sid = self._seq_of_slot[slot]
            while True:
                try:
                    if self.alloc.ensure_capacity(sid,
                                                  int(self.lengths[slot])):
                        self._set_table(slot, self.alloc.table(sid))
                    break
                except OutOfBlocks:
                    if not self._preempt_youngest(protect=slot):
                        raise RuntimeError(
                            "block pool too small for a single sequence: "
                            f"{self.alloc.num_blocks} x {self.bs}")

    # -- main tick --------------------------------------------------------
    def tick(self) -> list[Request]:
        self._admit()
        if not self.live:
            return []
        self._grow_tables()
        # free slots decode at position -1: their K/V writes are dropped
        # (layers.paged_kv_write) and their outputs ignored
        positions = np.full((self.B, 1), -1, np.int32)
        for slot in self.live:
            positions[slot, 0] = self.lengths[slot]
        L = self.model.cfg.num_layers
        bt, pos = self._tensor(self.bt), self._tensor(positions)
        cache = {**self.pages, "bt": bt.expand(L, *bt.shape),
                 "len": pos[:, 0].expand(L, self.B)}
        with self._rules_ctx():
            nxt, _ = self._decode(
                self.params,
                {"tokens": self._next[:, None], "positions": pos}, cache)
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
                self._release(slot)
        return finished
