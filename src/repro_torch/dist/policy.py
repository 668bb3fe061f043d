"""Memory-aware serve-layout policy, port of `repro.dist.policy`.

Per (arch x shape x mesh) cell it picks HOW weights are laid out across
the mesh and which KV-cache spec serves, from per-device memory and a
step-time proxy.

Candidate layouts (dist/sharding.py::SERVE_LAYOUTS, most stationary
first):

  stationary -- SERVE_RULES: weights tensor-parallel over "model" only,
                replicated over "data"; zero weight traffic per step.
  hybrid     -- HYBRID_SERVE_RULES: body weights stationary, the embedding
                / lm_head tables also sharded over "data".
  fsdp       -- DEFAULT_RULES: fully-sharded weights; always fits, pays
                weight all-gathers per step.

Each weight layout is paired with every CACHE_SPEC_CANDIDATES entry
(head/bf16, ring/bf16, head/int8, ring/int8), plus chunked-prefill
variants for long-prompt prefill cells.  int8 cache reads are charged at
bf16-equivalent bytes in the step-time proxy, so quantization is a FIT
tool and head/bf16 wins whenever it fits.

`decide`: a candidate is FEASIBLE when `hbm_bytes <= budget * margin`
(margin 0.9: 10% headroom for allocator fragmentation and collective
scratch); the fastest feasible step wins (ties: the earlier candidate,
more stationary, default cache first); with nothing feasible the
smallest peak wins and `fits=False`.

The budget and bandwidths come from a hardware model (dist/hardware.py,
one H100 by default; `hw=` takes another, which is how the tests hold
the decisions to the reference's at its own constants).  Evaluators:

  * analytic_eval(...)      -- exact per-device param / cache / input
    bytes from the ParamDef tree resolved through the candidate's
    RuleSet, plus an activation workspace, with a streaming step-time
    proxy.  The port has no compiler to probe candidates with, so every
    decision it makes is analytic.
  * eval_from_measured(...) -- a candidate's peak from a step that really
    ran on the card (dist/hardware.memory_dict) and its step time from a
    roofline: the only ground truth the card gives in place of XLA's
    memory_analysis.

The port's paged pool holds one block more than the reference's (the
sink of dropped writes, models/cache.py); its bytes count as allocated.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.dist import hardware
from repro_torch.dist.sharding import (SERVE_LAYOUTS, logical_to_mesh_spec,
                                       mesh_sizes, serve_layout_rules)

#: Fraction of the budget a layout may use before it is infeasible.
DEFAULT_MARGIN = 0.9


# ---------------------------------------------------------------------------
# Evaluations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateEval:
    """Predicted peak memory + step time for one (weight layout x cache
    spec) candidate.  `cache` is a models/cache.CacheSpec name
    ("ring/int8", ...; "" = the model's default spec / no cache);
    `chunked` marks the chunked-prefill variant."""
    layout: str
    hbm_bytes: float          # peak per-device memory the program needs
    step_time_s: float        # predicted step time
    source: str = "analytic"  # "measured" (a run on the card) | "analytic"
    detail: dict = dataclasses.field(default_factory=dict)
    cache: str = ""
    chunked: bool = False

    @property
    def key(self) -> str:
        """Unique candidate id: layout[+cache][+chunked]."""
        k = self.layout
        if self.cache:
            k += f"+{self.cache}"
        if self.chunked:
            k += "+chunked"
        return k

    def as_dict(self) -> dict:
        return {"layout": self.layout, "hbm_bytes": self.hbm_bytes,
                "hbm_gb": round(self.hbm_bytes / 1e9, 3),
                "step_time_s": self.step_time_s, "source": self.source,
                **({"cache": self.cache} if self.cache else {}),
                **({"chunked": True} if self.chunked else {}),
                **({"detail": self.detail} if self.detail else {})}


def peak_hbm_bytes(memory: dict) -> float:
    """Peak per-device memory of a measured run (`memory_dict`)."""
    return float(memory.get("peak_bytes", 0))


def eval_from_measured(layout: str, memory: dict, roofline: dict, *,
                       cache: str = "", chunked: bool = False
                       ) -> CandidateEval:
    """CandidateEval from a step that ran on the card: its allocator peak
    (dist/hardware.memory_dict) and a roofline dict with `bound_s`."""
    return CandidateEval(
        layout=layout, hbm_bytes=peak_hbm_bytes(memory),
        step_time_s=float(roofline.get("bound_s", 0.0)),
        source="measured", detail={"memory": dict(memory)},
        cache=cache, chunked=chunked)


# ---------------------------------------------------------------------------
# Analytic evaluator
# ---------------------------------------------------------------------------

def sharded_bytes(defs, mesh, rules) -> float:
    """Exact per-device bytes of a ParamDef tree laid out under `rules`."""
    from repro_torch.tree import leaves
    sizes = mesh_sizes(mesh)
    total = 0.0
    for d in leaves(defs):
        spec = logical_to_mesh_spec(d.logical_axes, d.shape, mesh, rules)
        shard = 1
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shard *= sizes.get(ax, 1)
        total += (d.dtype.itemsize * math.prod(d.shape)) / shard
    return total


#: Tokens per chunk of the chunked-prefill variant.
CHUNK_TOKENS = 4096

#: CacheSpec candidates the serve policy sweeps per weight layout, in
#: preference order (int8 is a fit tool: its reads are charged at bf16
#: bytes, so bf16 wins whenever both fit).
CACHE_SPEC_CANDIDATES = ("head/bf16", "ring/bf16", "head/int8", "ring/int8")


def _cache_bytes(model, shape, mesh, rules, cache_spec):
    """(resident_bytes, stream_bytes) of the decode/prefill cache under
    `cache_spec` ("" / None = the model's config default).  stream_bytes
    is what the attention must move per step, charged at bf16 width even
    for int8 caches (quantizing shrinks residency, the fit story)."""
    if shape.kind not in ("decode", "prefill") or model._cache_defs is None:
        return 0.0, 0.0
    B, S = shape.global_batch, shape.seq_len
    if cache_spec and model.supports_cache_spec:
        from repro_torch.models.cache import CacheSpec
        spec = CacheSpec.parse(cache_spec)
        resident = sharded_bytes(model.cache_defs(B, S, spec=spec),
                                 mesh, rules)
        if spec.quantized:
            bf16 = dataclasses.replace(spec, dtype="bf16")
            stream = sharded_bytes(model.cache_defs(B, S, spec=bf16),
                                   mesh, rules)
        else:
            stream = resident
        return resident, stream
    resident = sharded_bytes(model.cache_defs(B, S), mesh, rules)
    return resident, resident


def analytic_eval(model, shape, mesh, layout: str, *,
                  cache_spec: str | None = None, chunked: bool = False,
                  hbm_bw: float | None = None,
                  hw: hardware.Hardware | None = None) -> CandidateEval:
    """Compile-free CandidateEval: param/cache/input bytes from the
    ParamDef tree resolved through the (layout, cache_spec) candidate's
    RuleSet, plus a 2-deep activation workspace, with a
    weight/cache-streaming step-time proxy.

    The proxy charges every byte the device must READ each step at the
    memory bandwidth (stationary weights stream from local memory), plus
    the weights an fsdp or hybrid layout must first gather at the
    "data" axis's bandwidth (`hw.link_bw`), which is what makes
    stationary win whenever it fits.  Prefill counts the produced cache
    against peak too.  `chunked`: peak activations shrink to one
    CHUNK_TOKENS chunk, but the weights stream once per chunk.
    """
    hw = hw or hardware.H100
    hbm_bw = hbm_bw or hw.hbm_bw
    rules = serve_layout_rules(layout)
    stationary = serve_layout_rules("stationary")

    p_bytes = sharded_bytes(model.param_defs(), mesh, rules)
    in_bytes = sharded_bytes(model.input_defs(shape), mesh, rules)
    c_bytes, c_stream = _cache_bytes(model, shape, mesh, rules, cache_spec)
    if shape.kind == "prefill" and not cache_spec:
        # the reference's baseline: a prefill peak without the cache
        # output; product candidates carry a cache_spec and count it
        c_bytes = c_stream = 0.0
    # activation workspace: ~2 live (tokens/dev, d_model) bf16 copies
    sizes = mesh_sizes(mesh)
    data_deg = sizes.get("data", 1) * sizes.get("pod", 1)
    toks = shape.global_batch * (1 if shape.kind == "decode" else
                                 shape.seq_len)
    n_chunks = 1
    peak_toks = toks
    if chunked:
        n_chunks = max(1, math.ceil(shape.seq_len / CHUNK_TOKENS))
        peak_toks = shape.global_batch * min(CHUNK_TOKENS, shape.seq_len)
    act_peak = 2.0 * (peak_toks / max(data_deg, 1)) * \
        getattr(model.cfg, "d_model", 1) * 2
    act_total = 2.0 * (toks / max(data_deg, 1)) * \
        getattr(model.cfg, "d_model", 1) * 2

    # weight bytes gathered per step to compute stationary-style (0 for
    # stationary); chunked prefill re-gathers them once per chunk
    p_stationary = sharded_bytes(model.param_defs(), mesh, stationary)
    gather_bytes = max(p_stationary - p_bytes, 0.0)
    step = (p_bytes * n_chunks + c_stream + act_total) / hbm_bw \
        + gather_bytes * n_chunks / hw.link_bw
    return CandidateEval(
        layout=layout,
        hbm_bytes=p_bytes + c_bytes + in_bytes + act_peak,
        step_time_s=step,
        source="analytic",
        detail={"param_bytes": p_bytes, "cache_bytes": c_bytes,
                "cache_stream_bytes": c_stream,
                "activation_bytes": act_peak,
                "gather_bytes_per_step": gather_bytes,
                "n_chunks": n_chunks},
        cache=cache_spec or "", chunked=chunked)


# ---------------------------------------------------------------------------
# Decision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """The chosen (layout, cache_spec, chunked) plus the full
    per-candidate scoring table."""
    layout: str
    fits: bool                      # chosen candidate under budget*margin?
    budget_bytes: float
    margin: float
    evals: tuple                    # CandidateEval, in evaluation order
    reason: str
    cache_spec: str = ""            # "" = the model's config default
    chunked: bool = False

    @property
    def rules(self):
        return serve_layout_rules(self.layout)

    @property
    def key(self) -> str:
        k = self.layout
        if self.cache_spec:
            k += f"+{self.cache_spec}"
        if self.chunked:
            k += "+chunked"
        return k

    @property
    def chosen(self) -> CandidateEval:
        for e in self.evals:
            if e.key == self.key:
                return e
        for e in self.evals:
            if e.layout == self.layout:
                return e
        raise KeyError(self.key)

    def headroom_bytes(self, e: CandidateEval | None = None) -> float:
        e = e or self.chosen
        return self.budget_bytes * self.margin - e.hbm_bytes

    def as_dict(self) -> dict:
        return {
            "layout": self.layout, "fits": self.fits,
            **({"cache_spec": self.cache_spec} if self.cache_spec else {}),
            **({"chunked": True} if self.chunked else {}),
            "budget_gb": round(self.budget_bytes / 1e9, 2),
            "margin": self.margin,
            "headroom_gb": round(self.headroom_bytes() / 1e9, 3),
            "reason": self.reason,
            "candidates": [e.as_dict() for e in self.evals],
        }


def decide(evals, *, budget_bytes: float | None = None,
           margin: float = DEFAULT_MARGIN,
           hw: hardware.Hardware | None = None) -> LayoutDecision:
    """Headroom-aware scoring: feasible = peak <= budget*margin (budget:
    `budget_bytes`, else the hardware model's memory); the fastest
    feasible candidate wins (ties: first in `evals` order); with no
    feasible candidate the smallest peak wins and `fits=False`."""
    evals = tuple(evals)
    if not evals:
        raise ValueError("no candidate evaluations")
    if budget_bytes is None:
        budget_bytes = (hw or hardware.H100).hbm_bytes
    cap = budget_bytes * margin
    feasible = [e for e in evals if e.hbm_bytes <= cap]
    if feasible:
        best = min(feasible, key=lambda e: e.step_time_s)
        reason = (f"{best.key}: peak {best.hbm_bytes/1e9:.2f} GB <= "
                  f"{cap/1e9:.2f} GB budget "
                  f"(headroom {(cap-best.hbm_bytes)/1e9:.2f} GB), fastest "
                  f"feasible step {best.step_time_s:.3g}s of "
                  f"{len(feasible)}/{len(evals)} feasible")
        return LayoutDecision(best.layout, True, budget_bytes, margin,
                              evals, reason, cache_spec=best.cache,
                              chunked=best.chunked)
    best = min(evals, key=lambda e: e.hbm_bytes)
    reason = (f"no layout fits under {cap/1e9:.2f} GB "
              f"({margin:.0%} of {budget_bytes/1e9:.0f} GB); falling back "
              f"to min-peak {best.key} at {best.hbm_bytes/1e9:.2f} GB "
              f"(over by {(best.hbm_bytes-cap)/1e9:.2f} GB)")
    return LayoutDecision(best.layout, False, budget_bytes, margin,
                          evals, reason, cache_spec=best.cache,
                          chunked=best.chunked)


def choose_serve_layout(evaluate, *, layouts=None,
                        budget_bytes: float | None = None,
                        margin: float = DEFAULT_MARGIN,
                        hw: hardware.Hardware | None = None
                        ) -> LayoutDecision:
    """Evaluate every candidate layout with `evaluate(name) ->
    CandidateEval` (most-stationary-first order) and decide."""
    layouts = list(layouts) if layouts is not None else list(SERVE_LAYOUTS)
    return decide([evaluate(name) for name in layouts],
                  budget_bytes=budget_bytes, margin=margin, hw=hw)


def serve_product_candidates(model, shape):
    """(layout, cache_spec, chunked) product candidates for one serve
    cell, in preference order: layouts most-stationary-first; within a
    layout head/bf16 first; chunked-prefill variants last.  Cache specs
    enter only for cells with a spec'able cache; chunked prefill is
    excluded for the VLM stub (its patch prefix assumes one-shot
    prefill) and enc-dec archs (cross-attention frames)."""
    has_cache = (shape.kind in ("decode", "prefill")
                 and model._cache_defs is not None
                 and model.supports_cache_spec)
    chunk_ok = (shape.kind == "prefill" and has_cache
                and getattr(model.cfg, "frontend", "none") == "none"
                and not model.cfg.is_encdec
                and shape.seq_len > CHUNK_TOKENS)
    out = []
    for layout in SERVE_LAYOUTS:
        if not has_cache:
            out.append((layout, None, False))
            continue
        for spec in CACHE_SPEC_CANDIDATES:
            out.append((layout, spec, False))
    if chunk_ok:
        for layout in SERVE_LAYOUTS:
            for spec in CACHE_SPEC_CANDIDATES:
                out.append((layout, spec, True))
    return out


def analytic_serve_decision(model, shape, mesh, *,
                            budget_bytes: float | None = None,
                            margin: float = DEFAULT_MARGIN,
                            hw: hardware.Hardware | None = None
                            ) -> LayoutDecision:
    """Analytic decision for serve launchers (serve.py / ServeLoop /
    dryrun): scores the full (weight layout x cache spec [x chunked])
    product."""
    evals = [analytic_eval(model, shape, mesh, layout, cache_spec=spec,
                           chunked=ch, hw=hw)
             for layout, spec, ch in serve_product_candidates(model, shape)]
    return decide(evals, budget_bytes=budget_bytes, margin=margin, hw=hw)
