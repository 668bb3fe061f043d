"""The port's cost walk (dist/cost.py) and hardware model
(dist/hardware.py) on the CPU.

  * a matmul's flops are exactly 2 M N K (mm, bmm, einsum, linear), kept
    by dtype; an L-layer Python loop counts L times one layer (the
    reference's scan-vs-unroll concern, tests/test_hlo_cost.py); a
    gradient counts the forward and the backward ops;
  * the walks of the same smoke prefill, decode and train step on meta
    tensors and on the CPU give equal totals (flops by dtype, bytes, ops
    by name), the kernels reporting by formula on both;
  * each kernel's reported work is its bound formula (the one
    chip_smoke.py's kernel table reads);
  * an op that needs host data is a diagnostic naming it;
  * `Roofline` equals the reference's at the reference's constants, and
    charges each dtype and mesh axis at its own rate on the H100 model.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.hlo_analysis import Roofline as JaxRoofline  # noqa: E402

from repro_torch import threefry
from repro_torch.configs import get_smoke_config
from repro_torch.dist import cost, hardware
from repro_torch.dist.hardware import Roofline
from repro_torch.kernels.fed_agg import ops as fa_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linrec import ops as lr_ops
from repro_torch.kernels.quant8 import ops as q8_ops
from repro_torch.launch.steps import (make_chunk_prefill_step,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.param import abstract_params, init_params
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_flops_are_exact(dtype):
    M, N, K = 24, 40, 56
    a, b = torch.ones(M, K, dtype=dtype), torch.ones(K, N, dtype=dtype)
    name = str(dtype).split(".")[-1]
    for fn in (lambda: a @ b, lambda: torch.einsum("mk,kn->mn", a, b),
               lambda: torch.nn.functional.linear(a, b.t())):
        res = cost.analyze(fn)
        assert res["flops_by_dtype"] == {name: 2 * M * N * K}
        assert res["diagnostics"] == []
    x = torch.ones(3, M, K, dtype=dtype)
    y = torch.ones(3, K, N, dtype=dtype)
    assert cost.analyze(torch.bmm, x, y)["flops"] == 3 * 2 * M * N * K
    # bytes: each input read once, the output written once
    assert cost.analyze(torch.mm, a, b)["hbm_bytes"] == \
        (M * K + K * N + M * N) * a.element_size()


def _layer(x, w):
    return torch.relu(x @ w) + x


@pytest.mark.parametrize("L", [1, 3, 7])
def test_layer_loop_counts_each_trip(L):
    x, w = torch.ones(8, 16), torch.ones(16, 16)
    one = cost.analyze(_layer, x, w)

    def stack(x):
        for _ in range(L):
            x = _layer(x, w)
        return x
    many = cost.analyze(stack, x)
    assert many["flops"] == L * one["flops"]
    assert many["hbm_bytes"] == L * one["hbm_bytes"]
    assert all(many["by_op"][k]["count"] == L * v["count"]
               for k, v in one["by_op"].items())


def test_gradient_counts_forward_and_backward():
    M, N, K = 16, 32, 24
    x = torch.ones(M, K)
    w = torch.ones(K, N, requires_grad=True)

    def fwd():
        return (x @ w).sum()

    def fwd_bwd():
        return torch.autograd.grad((x @ w).sum(), w)
    f = cost.analyze(fwd)
    fb = cost.analyze(fwd_bwd)
    assert f["flops"] == 2 * M * N * K
    # dL/dw = x^T g: one more (K, M) x (M, N) product; x needs none
    assert fb["flops"] == 2 * (2 * M * N * K)
    assert fb["hbm_bytes"] > f["hbm_bytes"]


def _batch(model, shape, device):
    out = {}
    for k, d in model.input_defs(shape).items():
        if device == "meta":
            out[k] = torch.empty(d.shape, dtype=d.dtype, device="meta")
        elif d.dtype == torch.int32:
            out[k] = torch.full(d.shape, 3, dtype=torch.int32)
        else:
            out[k] = torch.ones(d.shape, dtype=d.dtype)
    return out


def _walk(model, kind, device):
    if device == "meta":
        params = abstract_params(model.param_defs())
    else:
        params = init_params(threefry.key(0), model.param_defs())
    shape = ShapeConfig("t", kind, 16, 2)
    batch = _batch(model, shape, device)
    if kind == "prefill":
        return cost.analyze(make_prefill_step(model), params, batch)
    if kind == "decode":
        defs = model.cache_defs(2, 16)
        cache = abstract_params(defs) if device == "meta" else tree_map(
            lambda d: torch.zeros(d.shape, dtype=d.dtype), defs)
        return cost.analyze(make_decode_step(model), params, batch, cache)
    opt = adamw(1e-3)
    return cost.analyze(make_train_step(model, opt), params,
                        opt.init(params), batch)


WALKED = ["granite-20b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
          "recurrentgemma-9b", "phi-3-vision-4.2b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", WALKED)
def test_meta_and_cpu_walks_agree(arch, kind):
    model = build_model(get_smoke_config(arch))
    meta, cpu = _walk(model, kind, "meta"), _walk(model, kind, "cpu")
    assert meta["diagnostics"] == [] and cpu["diagnostics"] == []
    assert meta["out"] is not None
    assert cost.totals(meta) == cost.totals(cpu)
    assert meta["flops"] > 0 and meta["hbm_bytes"] > 0
    kernels = {k: v["count"] for k, v in meta["by_op"].items()
               if not k.startswith("aten.")}
    if kind == "prefill" and model.cfg.family != "ssm":
        assert kernels.get("flash_attention", 0) > 0
    if model.cfg.family in ("ssm", "hybrid") and kind != "train":
        assert kernels.get("linrec", 0) > 0
    if kind == "train":          # a gradient takes the plain routes
        assert kernels == {}


def test_int8_chunk_prefill_reports_quant8_on_meta_and_cpu():
    """A head/int8 chunk step: one grouped quantise (cache.write_kv) and
    one grouped dequantise (read_kv) a layer, reported on both."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("granite-20b"),
                              cache_spec="head/int8")
    model = build_model(cfg)
    res = {}
    for dev in ("meta", "cpu"):
        params = abstract_params(model.param_defs()) if dev == "meta" else \
            init_params(threefry.key(0), model.param_defs())
        defs = model.cache_defs(2, 32)
        cache = abstract_params(defs) if dev == "meta" else tree_map(
            lambda d: torch.zeros(d.shape, dtype=d.dtype), defs)
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32,
                                       device=dev),
                 "positions": torch.arange(8, dtype=torch.int32,
                                           device=dev).expand(2, 8),
                 "last_index": torch.full((2,), 7, dtype=torch.int32,
                                          device=dev)}
        res[dev] = cost.analyze(make_chunk_prefill_step(model), params,
                                batch, cache)
    assert cost.totals(res["meta"]) == cost.totals(res["cpu"])
    L = cfg.num_layers
    assert res["meta"]["by_op"]["quant8_quantize"]["count"] == L
    assert res["meta"]["by_op"]["quant8_dequantize"]["count"] == L


def test_kernels_report_their_bound_formulas():
    """Each dispatcher's report is the formula chip_smoke.py's kernel table
    bounds the kernel with (the same bytes and operations)."""
    g = torch.Generator().manual_seed(0)
    B, T, H, Hkv, D, window = 2, 40, 4, 2, 16, 24
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    k = torch.randn(B, T, Hkv, D, generator=g).bfloat16()
    v = torch.randn(B, T, Hkv, D, generator=g).bfloat16()
    res = cost.analyze(flash_ops.flash_attention, q, k, v, window=window)
    fl = res["by_op"]["flash_attention"]
    assert fl["count"] == 1 and set(res["by_op"]) == {"flash_attention"}
    ops = 4 * D * hardware.attention_pairs(T, window, True) * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    assert (fl["flops"], fl["bytes"]) == (ops, nbytes)
    assert res["flops_by_dtype"] == {"bfloat16": ops}
    t_ops, t_bytes = ops / 989e12 * 1e3, nbytes / 3.35e12 * 1e3
    assert hardware.work_bound(({"bfloat16": ops}, nbytes)) == \
        (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations")
    # brute-force pairs, S == T and S != T
    for T_, S_, w, c in ((40, 40, 24, True), (7, 12, 0, True),
                         (9, 5, 3, True), (6, 11, 0, False)):
        t, s = np.arange(T_)[:, None], np.arange(S_)[None, :]
        live = np.ones((T_, S_), bool)
        if c:
            live &= s <= t
        if w:
            live &= s > t - w
        assert hardware.attention_pairs(T_, w, c, S_) == int(live.sum())

    a = torch.rand(3, 50, 24, generator=g)
    b = torch.randn(3, 50, 24, generator=g)
    h0 = torch.randn(3, 24, generator=g)
    n = a.numel()
    for h, extra in ((None, 0), (h0, 4 * 3 * 24)):
        lr = cost.analyze(lr_ops.linrec, a, b, h)["by_op"]["linrec"]
        assert (lr["flops"], lr["bytes"]) == (2 * n, 12 * n + extra)

    xs = [torch.randn(5, 1027, generator=g),
          torch.randn(3, 256, generator=g).bfloat16()]
    qres = cost.analyze(q8_ops.quantize_rows_grouped, xs)
    qz = qres["by_op"]["quant8_quantize"]
    want = sum(x.numel() * x.element_size() + x.numel() + 4 * x.shape[0]
               for x in xs)
    assert (qz["count"], qz["flops"], qz["bytes"]) == \
        (1, 5 * sum(x.numel() for x in xs), want)
    qs, ss = zip(*q8_ops.quantize_rows_grouped(xs))
    dq = cost.analyze(q8_ops.dequantize_rows_grouped, qs, ss,
                      out_dtype=torch.bfloat16)["by_op"]["quant8_dequantize"]
    assert (dq["flops"], dq["bytes"]) == (
        sum(q.numel() for q in qs),
        sum(q.numel() + 4 * q.shape[0] + 2 * q.numel() for q in qs))

    K, N = 5, 20_490
    x = torch.randn(K, N, generator=g)
    fa = cost.analyze(fa_ops.fed_agg, x, np.full(K, 0.2))["by_op"]["fed_agg"]
    assert (fa["flops"], fa["bytes"]) == (2 * K * N, (K + 1) * N * 4)
    trees = [{"w": torch.randn(6, 7, generator=g),
              "b": torch.randn(7, generator=g).bfloat16()} for _ in range(2)]
    ft = cost.analyze(fa_ops.fed_agg_tree, trees, [0.3, 0.7])
    assert ft["by_op"]["fed_agg"]["bytes"] == 3 * 42 * 4 + 3 * 7 * 2
    # impl="ref" runs and is walked as the plain ops it is
    ref = cost.analyze(flash_ops.flash_attention, q, k, v, impl="ref")
    assert "flash_attention" not in ref["by_op"] and ref["flops"] > 0


def test_meta_dispatch_returns_empty_outputs_of_the_right_shape():
    q = torch.empty(2, 8, 4, 16, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 8, 1, 16, dtype=torch.bfloat16, device="meta")
    o = flash_ops.flash_attention(q, kv, kv)
    assert o.device.type == "meta" and o.shape == q.shape and \
        o.is_contiguous()
    a = torch.empty(2, 5, 7, device="meta")
    assert lr_ops.linrec(a, a).shape == (2, 5, 7)
    (qq, s), = q8_ops.quantize_rowwise_grouped([a])
    assert qq.dtype == torch.int8 and s.shape == (2, 5, 1)
    assert q8_ops.dequantize_rowwise(qq, s, out_dtype=torch.bfloat16) \
        .dtype == torch.bfloat16
    assert fa_ops.fed_agg(torch.empty(3, 4, 5, device="meta"),
                          [1 / 3] * 3).shape == (4, 5)
    with pytest.raises(ValueError):
        q8_ops.quantize_rows_grouped([a[0]], impl="nope")


def test_host_data_is_a_diagnostic_naming_the_op():
    x = torch.empty(4, device="meta")
    res = cost.analyze(lambda: x.sum().item())
    assert res["out"] is None
    assert "_local_scalar_dense" in res["diagnostics"][0]
    cpu = cost.analyze(lambda: torch.ones(4).sum().item())
    assert cpu["out"] == 4.0
    assert "reads host data" in cpu["diagnostics"][0]


def test_kernel_call_outside_a_walk_is_free():
    def work():
        raise AssertionError("work formula computed outside a walk")
    with cost.kernel_call("x", work):
        pass
    assert cost.active() is None
    with cost.walk() as w:
        with cost.walk() as inner:
            torch.ones(3) + 1          # ones writes 12 B; add 12 in, 12 out
        assert cost.active() is w
        torch.ones(2)
    # an op passes through every walk it runs under
    assert inner.result()["hbm_bytes"] == 36
    assert w.result()["hbm_bytes"] == 36 + 8


# the reference's constants: one rate, one link bandwidth
REF_HW = hardware.Hardware("reference constants", {"float32": 197e12},
                           819e9, 16e9, 50e9, 50e9)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e12, 1e9, 0.0), (1e9, 1e12, 2e9), (3e14, 2e11, 5e10), (0.0, 1.0, 0.0)])
def test_roofline_matches_reference(flops, nbytes, coll):
    want = JaxRoofline(flops, nbytes, coll).as_dict()
    got = Roofline({"bfloat16": flops}, nbytes, {"data": coll},
                   REF_HW).as_dict()
    assert {k: got[k] for k in want} == want


def test_roofline_charges_each_dtype_and_axis_at_its_rate():
    r = Roofline.of({"flops": 2e9, "hbm_bytes": 3.35e9,
                     "flops_by_dtype": {"bfloat16": 1e9, "float32": 1e9}},
                    {"model": 450e6, "data": 50e6})
    assert r.t_compute_s == pytest.approx(1e9 / 989e12 + 1e9 / 67e12)
    assert r.t_memory_s == pytest.approx(1e-3)
    assert r.t_collective_s == pytest.approx(2e-3)
    assert r.dominant == "collective" and r.bound_s == r.t_collective_s
    assert r.as_dict()["flops_by_dtype"] == {"bfloat16": 1e9,
                                             "float32": 1e9}
    h = hardware.H100
    assert (h.rate("bfloat16"), h.rate("float32"), h.rate("int8"),
            h.hbm_bw, h.hbm_bytes, h.axis_bw("data"), h.axis_bw("pod"),
            h.axis_bw("model")) == (989e12, 67e12, 67e12, 3.35e12, 80e9,
                                    50e9, 50e9, 450e9)
