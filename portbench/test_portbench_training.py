"""What differs between training cells comes from their own files: a
family's FLOPs from its layout, its auxiliary loss terms from its
reference, the loop's flags from the traffic file.  A toy mixture of
experts defined here, with a load-balance term and routed FLOPs, runs
through the driver's plan, facts and reference with no edit to the
harness; the reference's two-tier exchange and stale merge are held to
the program's."""
import math
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from portbench import core, gen, judge, roofline, weights
from portbench.drivers import fl_train as drv
from portbench.reference import fl_train as ref_fl_train
from portbench.trace import Trace

SEED = 2**31 + 23
COEF = 0.01


# -- a toy family: top-1 routed experts with a load-balance term ------------

def _toy_leaves(arch):
    V, d, L, E = (arch["vocab_size"], arch["d_model"], arch["num_layers"],
                  arch["num_experts"])
    s = 1 / math.sqrt(d)
    return sorted([("embed/tok", (V, d), "normal", 1.0),
                   ("embed/unembed", (d, V), "normal", s),
                   ("layers/router", (L, d, E), "normal", s),
                   ("layers/experts", (L, E, d, d), "normal", s)])


def _toy_n_params(arch, *, input_embedding=True):
    return sum(math.prod(shape) for p, shape, _, _ in _toy_leaves(arch)
               if input_embedding or p != "embed/tok")


def _toy_flops(arch, seq):
    """A token reaches experts_per_token of the experts held here."""
    d, L, E, k = (arch["d_model"], arch["num_layers"], arch["num_experts"],
                  arch["experts_per_token"])
    active = d * arch["vocab_size"] + L * (d * E + k * d * d)
    return 6.0 * active


def _toy_split(w, arch, dtype=torch.float32):
    top = {p: t.to(dtype).clone() for p, t in w.items()
           if not p.startswith("layers/")}
    layers = [{p[len("layers/"):]: t[i].to(dtype).clone()
               for p, t in w.items() if p.startswith("layers/")}
              for i in range(arch["num_layers"])]
    return top, layers


def _toy_forward(top, layers, tokens, arch, *, lowp=False):
    """-> logits, {counts, probs}: each layer's tokens a routed expert and
    router probability an expert, summed over the rows' tokens."""
    E = arch["num_experts"]
    x = F.embedding(tokens, top["embed/tok"]).float()
    counts, probs = [], []
    for lp in layers:
        pr = torch.softmax(x @ lp["router"], dim=-1)
        oh = F.one_hot(pr.argmax(-1), E).float()
        y = torch.einsum("btd,edf->btef", x, lp["experts"])
        x = x + (pr * oh).sum(-1, keepdim=True) * torch.tanh(
            (y * oh[..., None]).sum(-2))
        counts.append(oh.sum((0, 1)))
        probs.append(pr.sum((0, 1)))
    return x @ top["embed/unembed"], {"counts": torch.stack(counts),
                                      "probs": torch.stack(probs)}


def _toy_terms(sums, n_tokens, arch):
    """E x sum over layers and experts of (share of tokens) x (mean
    router probability): the product of two batch means."""
    return {"load_balance": arch["num_experts"] * (
        sums["counts"] / n_tokens * sums["probs"] / n_tokens).sum()}


TOY_LAYOUT = types.SimpleNamespace(leaves=_toy_leaves, n_params=_toy_n_params,
                                   train_flops_per_token=_toy_flops)
TOY_REFERENCE = types.SimpleNamespace(split=_toy_split, forward=_toy_forward,
                                      terms=_toy_terms)
TOY_ARCH = {"name": "toy-moe", "family": "toy_moe", "num_layers": 2,
            "d_model": 16, "vocab_size": 64, "num_experts": 4,
            "experts_per_token": 1, "dtype": "bfloat16"}


@pytest.fixture
def toy_family(monkeypatch):
    """The family's two files, found by name as any family's are."""
    monkeypatch.setitem(sys.modules, "portbench.layouts.toy_moe", TOY_LAYOUT)
    monkeypatch.setitem(sys.modules, "portbench.reference.toy_moe",
                        TOY_REFERENCE)


def _toy_run(loss_terms):
    cfg = {"as_run": dict(TOY_ARCH), "harness": {"loss_terms": loss_terms}}
    tr = core.traffic_of("fl-q8") | {"batch": 4, "seq": 8,
                                     "stream_tokens": 4000}
    return core.Run("toy", cfg, tr, SEED, 1.0, False, torch.device("cpu"))


def _direct(w0, x, y, coef):
    """The whole batch at once: loss and clipped gradient norms."""
    top, layers = _toy_split(w0, TOY_ARCH)
    flat = list(top.values()) + [t for lp in layers for t in lp.values()]
    for t in flat:
        t.requires_grad_()
    lg, sums = _toy_forward(top, layers, x, TOY_ARCH)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), y.reshape(-1))
    loss = loss + coef * _toy_terms(sums, x.numel(), TOY_ARCH)["load_balance"]
    g = torch.autograd.grad(loss, flat)
    norm = math.sqrt(sum(float(a.square().sum()) for a in g))
    g = [a * min(1.0 / norm, 1.0) for a in g]
    out = {p: a.norm().item() for p, a in zip(top, g)}
    n_top, keys = len(top), list(layers[0])
    for j, k in enumerate(keys):
        out["layers/" + k] = math.sqrt(sum(
            g[n_top + i * len(keys) + j].norm().item() ** 2
            for i in range(len(layers))))
    return loss.item(), out


def test_a_new_family_needs_only_its_own_files(toy_family):
    run = _toy_run({"load_balance": COEF})
    plan = drv.plan(run)
    assert plan["hp"]["loss_terms"] == {"load_balance": COEF}
    f = drv.facts(run, plan["layout"])
    assert f["train_flops_per_token"] == _toy_flops(TOY_ARCH, 8)
    assert f["q8_elements"] == 2 * _toy_n_params(TOY_ARCH)
    ref = drv.reference(run, plan)
    assert len(ref["loss"]) == 3 and len(ref["loss"][0]) == 2
    # step 1, island 0: cross entropy + 0.01 x the whole batch's term
    w0 = weights.flatten(weights.make(plan["layout"], SEED, "cpu"))
    x, y = gen.lm_rows(gen.token_stream(64, 4000, SEED, island=0), 4, 8, 0)
    x, y = torch.as_tensor(x).long(), torch.as_tensor(y).long()
    loss, grad = _direct(w0, x, y, COEF)
    assert math.isclose(ref["loss"][0][0], loss, rel_tol=1e-6)
    for p, v in grad.items():
        assert math.isclose(ref["grad"][p][0], v, rel_tol=1e-5), p
    # without the term the loss is the cross entropy alone, and lower
    lb_free = _direct(w0, x, y, 0.0)[0]
    assert loss - lb_free > 0.5 * COEF


@pytest.mark.parametrize("terms", [{}, {"load_balance": COEF, "z": 1e-3}],
                         ids=["missing", "extra"])
def test_loss_terms_must_be_the_familys(toy_family, terms):
    run = _toy_run(terms)
    with pytest.raises(ValueError, match="loss terms"):
        drv.reference(run, drv.plan(run))


def test_chunked_and_whole_batch_terms_agree(toy_family):
    run = _toy_run({"load_balance": COEF})
    plan = drv.plan(run)
    w0 = weights.flatten(weights.make(plan["layout"], SEED, "cpu"))
    rows = []
    for s in range(2):
        x, y = gen.lm_rows(gen.token_stream(64, 4000, SEED, island=0), 4, 8,
                           s)
        rows.append([(torch.as_tensor(x).long(), torch.as_tensor(y).long())])
    hp = plan["hp"] | {"islands": 1, "local_steps": 2}
    got = [ref_fl_train.run(TOY_REFERENCE, TOY_ARCH, w0, rows, hp, n_steps=2,
                            rows_per_chunk=k) for k in (1, 4)]
    for a, b in zip(got[0]["loss"], got[1]["loss"]):
        assert a == pytest.approx(b, rel=1e-6)
    for key in ("grad", "change"):
        assert judge._leaf_gap(got[0][key], got[1][key]) < 1e-5, key


# -- dense FLOPs, the loop's flags, the configuration's keys ---------------

def test_dense_flops_are_the_old_formula_for_qwen():
    arch = core.config_of(core.load_manifest(), "qwen1.5-4b-fl8")["as_run"]
    n = core.layout("dense").n_params(arch, input_embedding=False)
    old = 6.0 * n + 12.0 * arch["num_layers"] * arch["d_model"] * 1024
    assert core.layout("dense").train_flops_per_token(arch, 1024) == old


def _qwen_run(traffic):
    cfg = core.config_of(core.load_manifest(), "qwen1.5-4b-fl8")
    return core.Run("w", cfg, core.traffic_of(traffic), 7, 1.0, False,
                    torch.device("cpu"))


def test_program_flags_come_from_the_traffic_file():
    run = _qwen_run("fl-q8")
    assert drv.program_argv(run, drv.plan(run)["hp"]) == [
        "--full", "--islands", "2", "--local-steps", "2", "--compress",
        "q8", "--batch", "8", "--seq", "1024", "--lr", "0.003", "--steps",
        "100000", "--seed", "7", "--device", "cpu"]
    fog = _qwen_run("fl-fog-e1-sync")
    argv = drv.program_argv(fog, drv.plan(fog)["hp"])
    assert argv[argv.index("--local-steps") + 1] == "1"
    assert argv[-2:] == ["--fog-cells", "2"]
    fog.traffic["overlap"] = True
    assert drv.program_argv(fog, drv.plan(fog)["hp"])[-3:] == [
        "--fog-cells", "2", "--overlap"]
    assert drv.facts(fog, drv.plan(fog)["layout"])["q8_hops"] == 2
    assert drv.facts(run, drv.plan(run)["layout"])["q8_hops"] == 1


def test_as_run_is_the_programs_config_alone():
    arch = core.config_of(core.load_manifest(), "qwen1.5-4b-fl8")["as_run"]
    assert drv.model_config(arch).d_model == 2560
    with pytest.raises(ValueError, match="rms_norm_eps"):
        drv.model_config(arch | {"rms_norm_eps": 1e-6})


# -- the reference's exchange against the program's -----------------------

@pytest.mark.parametrize("P,cells", [(2, 1), (2, 2), (4, 2)])
def test_reference_exchange_is_the_programs(P, cells):
    from repro_torch.core import federated, hierarchy
    g = torch.Generator().manual_seed(P * 10 + cells)
    shapes = {"a": (3, 40), "b": (2, 5, 33), "c": (129,)}
    base = {k: torch.randn(s, generator=g).to(torch.bfloat16)
            for k, s in shapes.items()}
    x = {k: (base[k].float() + 0.01 * torch.randn((P,) + s, generator=g))
         .to(torch.bfloat16) for k, s in shapes.items()}
    stacked_base = federated.stack_islands(base, P)
    w = torch.full((P,), 1.0 / P).numpy()
    if cells > 1:
        got = hierarchy.hierarchical_sync_aggregate(
            x, w, [i % cells for i in range(P)], compress="q8",
            base_params=stacked_base)
    else:
        M = torch.full((P, P), 1.0 / P)
        got = federated.fl_aggregate_compressed(x, stacked_base, M)
    for k in shapes:
        want = ref_fl_train.exchange([x[k][i].float() for i in range(P)],
                                     base[k].float(), cells)
        for i in range(P):
            assert torch.equal(got[k][i].float(), want), (k, i)


def test_reference_merge_is_the_programs():
    from repro_torch.core import federated
    g = torch.Generator().manual_seed(5)
    p, m, s = (torch.randn(2, 7, 31, generator=g).to(torch.bfloat16)
               for _ in range(3))
    got = federated.fl_overlap_merge({"w": p}, {"w": m}, {"w": s})["w"]
    assert torch.equal(got.float(), ref_fl_train.merge(p.float(), m.float(),
                                                       s.float()))


# -- quant8's bytes, hop by hop ----------------------------------------------

@pytest.mark.parametrize("hops", [1, 2])
def test_quant8_roofline_counts_every_hop(hops):
    rec = core.Record(trace=Trace([("quantize_grouped_k", 0.0, 300.0),
                                   ("dequantize_grouped_k", 400.0, 200.0),
                                   ("other", 700.0, 50.0)], [], 0.0, 1e3))
    rec.add("exchange", 0.0, 1.0, in_window=True, traced=True)
    rec.add("exchange", 1.0, 2.0, in_window=True, traced=False)
    rec.facts.update(q8_elements=1_000_000, q8_rows=1_000, q8_hops=hops)
    got = core.metric_reader("quant8_roofline")(
        core.Run("w", {}, {}, 0, 1.0, True, "cpu", rec))
    q, dq = roofline.quant8_bytes(1_000_000, 1_000)
    assert math.isclose(got, 100.0 * hops * (q + dq) / roofline.HBM_BYTES
                        / 500e-6)
