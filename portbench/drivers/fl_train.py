"""Driver of federated LM training: `repro_torch.launch.train.main`, the
program's own loop (islands, E local steps, the compressed exchange, flat
or through fog cells, applied at once or one step stale), fed with the
benchmark's weights and token streams.

What differs between training cells comes from their files: the
program's `ModelConfig` is the configuration's `as_run` (an unknown key
is refused), what only the reference reads is its `harness` section
(the norm epsilon, the coefficient of each auxiliary loss term), the
FLOPs a token are the family layout's, and the traffic file gives the
loop's flags (`program_argv`: `fog_cells` and `overlap` where it states
them).

The program is given four of its globals for the run (`core.patched`):
`init_params_on_device` returns the benchmark's weights made from the
seed; `make_token_stream` the benchmark's stream of each island; around
the step that `make_fl_train_step` builds and the exchange (the callable
`make_fl_aggregate` builds, or `hierarchy.hierarchical_sync_aggregate`,
both hops, through fog cells) sit the benchmark's spans, synchronised in
the traced run only (the program itself synchronises after every step).
Set-up is the process start, the weights and the first `warm_steps`
steps (at least two exchange rounds: every shape and kernel the window
runs, and the steps the reference follows).  The window opens at the
next step's call, after one synchronise, and closes at the first call
after a whole exchange round that ends past `--seconds`, after another;
the step wrapper then raises `WindowClosed`, which ends `main`.  The
traced run profiles the whole rounds that hold the first two steps
after 30 % of the window.  The program's readings for the output check
are taken on the way: each island's loss of the first steps, the first
gradient as AdamW got it (its first moment after one step over 1 - b1),
and the params' change from the initial weights after `check_steps`
steps, read at the next step's call before that step updates them in
place."""
from __future__ import annotations

import dataclasses
import math

import torch

from portbench import core, gen, judge, weights
from portbench.reference import fl_train as ref_fl_train
from portbench.trace import Profiler

#: steps the traced rounds hold at least: the first one's step range
#: opened before the profiler started, so the second is a whole one
TRACED_STEPS = 2


class WindowClosed(Exception):
    pass


def _norm_f32(t) -> float:
    return float(t.float().norm())


class Hooks:
    def __init__(self, run, layout_leaves, hp):
        self.run, self.layout, self.hp = run, layout_leaves, hp
        self.rec = run.record
        self.calls = 0
        self.w0 = None
        self.readings = {"loss": [], "grad": {}, "change": {}}
        self.t_start = None
        self.t_end = None
        self.prof = None
        self.prof_from = None
        self.traced = False

    # -- the program's globals ------------------------------------------
    def init_params_on_device(self, seed, defs, device):
        weights.check_against(self.layout, defs)
        if self.run.trace:
            Profiler(device).warm()
        self.w0 = weights.make(self.layout, self.run.seed, device)
        return self.w0

    def make_token_stream(self, vocab, n_tokens, *, seed=0, **_):
        if n_tokens != self.run.traffic["stream_tokens"]:
            raise ValueError(f"the program asks for a stream of {n_tokens} "
                             "tokens; the traffic file states "
                             f"{self.run.traffic['stream_tokens']}")
        return gen.token_stream(vocab, n_tokens, self.run.seed,
                                island=seed - self.run.seed)

    def make_fl_train_step(self, real_factory):
        def factory(model, opt, n_islands, **kw):
            real = real_factory(model, opt, n_islands, **kw)

            def step(params, opt_state, batch):
                return self.step(real, params, opt_state, batch)
            return step
        return factory

    def make_fl_aggregate(self, real_factory):
        def factory(*a, **kw):
            return self.timed_exchange(real_factory(*a, **kw))
        return factory

    def timed_exchange(self, real):
        """`real` (one whole exchange) inside the benchmark's span."""
        def agg(*args, **kw):
            trace = self.run.trace
            if trace:
                self.sync()
            t0 = core.now()
            with torch.profiler.record_function("bench.exchange"):
                out = real(*args, **kw)
            if trace:
                self.sync()
                self.rec.add("exchange", t0, core.now(),
                             in_window=self.t_start is not None,
                             traced=self.prof is not None)
            return out
        return agg

    # -- the step --------------------------------------------------------
    def sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self, real, params, opt_state, batch):
        self.calls += 1
        k, hp = self.calls, self.hp
        if k == hp["check_steps"] + 1:
            self.read_change(params)
        first = hp["warm_steps"] + 1
        if k == first:
            self.sync()
            if self.run.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.t_start = core.now()
        elif k > first and (k - first) % hp["local_steps"] == 0:
            # a round's end: only its exchange may still run on the card
            if self.run.trace:
                self.sync()
            if self.prof is not None and k - self.prof_from >= TRACED_STEPS:
                self.rec.trace = self.prof.stop()
                self.prof = None
            if core.now() - self.t_start >= self.run.seconds:
                if self.prof is not None:     # a window shorter than that
                    self.rec.trace = self.prof.stop()
                    self.prof = None
                self.sync()
                self.t_end = core.now()
                self.rec.counters["window_steps"] = k - first
                raise WindowClosed
            if self.run.trace and not self.traced and \
                    core.now() - self.t_start >= 0.3 * self.run.seconds:
                self.prof = Profiler(self.run.device)
                self.prof.start()
                self.prof_from = k
                self.traced = True
        t0 = core.now()
        with torch.profiler.record_function("bench.step"):
            out = real(params, opt_state, batch)
        if self.run.trace:
            self.sync()
            self.rec.add("step", t0, core.now(), in_window=k >= first,
                         traced=self.prof is not None)
        if k <= hp["check_steps"]:
            self.readings["loss"].append(
                [float(x) for x in out[2]["loss"].float().cpu()])
        if k == 1:
            self.read_grad(out[1])
        return out

    def read_grad(self, opt_state):
        """mu = (1 - b1) g after one step from zero; a state that did not
        count exactly one step reads NaN, which no limit passes."""
        mu = weights.flatten(opt_state["mu"])
        one = bool((opt_state["count"] == 1).all())
        scale = 1.0 / (1.0 - self.hp["b1"]) if one else float("nan")
        self.readings["grad"] = {
            p: [_norm_f32(t[i]) * scale for i in range(t.shape[0])]
            for p, t in mu.items()}

    def read_change(self, params):
        w0 = weights.flatten(self.w0)
        cur = weights.flatten(params)
        self.readings["change"] = {
            p: [_norm_f32(cur[p][i].float() - w0[p].float())
                for i in range(cur[p].shape[0])] for p in cur}
        self.w0 = None          # the initial weights are no longer needed


def plan(run) -> dict:
    """The cell's weight layout and the job's settings: the traffic's
    optimizer and loop, the configuration's loss terms."""
    arch, tr = run.config["as_run"], run.traffic
    hp = tr["optimizer"] | {k: tr[k] for k in (
        "islands", "local_steps", "warm_steps", "check_steps")}
    hp |= {"fog_cells": tr.get("fog_cells", 1),
           "overlap": tr.get("overlap", False),
           "loss_terms": run.config.get("harness", {}).get("loss_terms", {})}
    return {"layout": core.layout(arch["family"]).leaves(arch), "hp": hp}


def model_config(arch: dict):
    """The program's ModelConfig of `as_run`, every key one of its
    fields."""
    from repro_torch.models.config import ModelConfig

    unknown = set(arch) - {f.name for f in dataclasses.fields(ModelConfig)}
    if unknown:
        raise ValueError(f"as_run keys the program's ModelConfig does not "
                         f"have: {sorted(unknown)} (what only the harness "
                         "reads belongs in the configuration's `harness`)")
    return ModelConfig(**arch)


def program_argv(run, hp: dict) -> list:
    """`launch/train.py`'s flags for the cell."""
    tr = run.traffic
    argv = ["--full", "--islands", str(tr["islands"]), "--local-steps",
            str(tr["local_steps"]), "--compress", tr["compress"],
            "--batch", str(tr["batch"]), "--seq", str(tr["seq"]),
            "--lr", str(hp["lr"]), "--steps", str(hp["total_steps"]),
            "--seed", str(run.seed), "--device", str(run.device)]
    if "fog_cells" in tr:
        argv += ["--fog-cells", str(tr["fog_cells"])]
    if tr.get("overlap"):
        argv.append("--overlap")
    return argv


def facts(run, layout_leaves) -> dict:
    """What the readers need of the cell's shapes: the tokens and FLOPs
    (the family's) a step, and the exchange's quantised elements and rows
    a hop and its hops (two through fog cells)."""
    arch, tr = run.config["as_run"], run.traffic
    family = core.layout(arch["family"])
    P, B, T = tr["islands"], tr["batch"], tr["seq"]
    return {"tokens_per_step": P * B * T,
            "train_flops_per_token": family.train_flops_per_token(arch, T),
            "q8_elements": P * family.n_params(arch),
            "q8_rows": P * sum(math.prod(s[:-1])
                               for _, s, _, _ in layout_leaves),
            "q8_hops": 2 if tr.get("fog_cells", 1) > 1 else 1}


def run(run) -> dict:
    from repro_torch.core import hierarchy
    from repro_torch.launch import train as program
    from repro_torch.models import build_model

    p = plan(run)
    layout_leaves, hp = p["layout"], p["hp"]
    cfg = model_config(run.config["as_run"])
    weights.check_against(layout_leaves, build_model(cfg).param_defs())
    h = Hooks(run, layout_leaves, hp)
    with core.patched(
            program,
            init_params_on_device=h.init_params_on_device,
            make_token_stream=h.make_token_stream,
            make_fl_train_step=h.make_fl_train_step(
                program.make_fl_train_step),
            make_fl_aggregate=h.make_fl_aggregate(program.make_fl_aggregate)
    ), core.patched(hierarchy, hierarchical_sync_aggregate=h.timed_exchange(
            hierarchy.hierarchical_sync_aggregate)):
        try:
            program.main(program_argv(run, hp), cfg=cfg)
        except WindowClosed:
            pass
    if h.t_end is None:
        raise RuntimeError("the train loop ended before the window closed")
    rec = run.record
    rec.facts["setup_end"] = h.t_start
    rec.facts.update(facts(run, layout_leaves))
    steps = rec.counters["window_steps"]
    rec.end_to_end["train_tokens_per_s"] = (
        steps * rec.facts["tokens_per_step"] / (h.t_end - h.t_start))
    rec.counters["attempted"] = steps
    rec.counters["failed"] = 0
    if run.device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    return {"program": h.readings, **p}


def reference(run, measured, variant: str = "") -> dict:
    """The reference's readings of the same first steps (after the
    program's state is freed)."""
    tr = run.traffic
    hp = measured["hp"]
    arch = run.config["as_run"] | {
        k: v for k, v in run.config.get("harness", {}).items()
        if k != "loss_terms"}
    model = core.reference(arch["family"])
    w0 = weights.flatten(weights.make(measured["layout"], run.seed,
                                      run.device))
    P = tr["islands"]
    rows = []
    for s in range(hp["check_steps"]):
        per = []
        for i in range(P):
            x, y = gen.lm_rows(gen.token_stream(
                arch["vocab_size"], tr["stream_tokens"], run.seed, island=i),
                tr["batch"], tr["seq"], s)
            per.append((torch.as_tensor(x, device=run.device).long(),
                        torch.as_tensor(y, device=run.device).long()))
        rows.append(per)
    return ref_fl_train.run(model, arch, w0, rows, hp,
                            n_steps=hp["check_steps"], variant=variant)


def numbers(measured, ref) -> dict:
    return judge.train_numbers(measured["program"], ref)


def variant_numbers(run, plan_, ref, variant: str) -> dict:
    """The control or a planted fault in the program's place."""
    return numbers({**plan_, "program": reference(run, plan_, variant)}, ref)
