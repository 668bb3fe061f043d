"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc (marker `cuda`) and skips
elsewhere.  The file imports no JAX, so it runs on the machine with the
card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aggregation as tagg
from repro_torch.examples import fl_exchange
from repro_torch.kernels.fed_agg import kernel as tkernel
from repro_torch.kernels.fed_agg.ops import fed_agg
from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref
from repro_torch.kernels.quant8 import kernel as q8kernel
from repro_torch.kernels.quant8 import ops as q8ops
from repro_torch.kernels.quant8.ref import (dequantize_rows_ref,
                                            quantize_rows_ref)
from repro_torch.models.param import from_reference
from repro_torch.tree import leaves

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(K, n, seed=0):
    rng = np.random.default_rng(seed + 97 * K + n)
    return rng.normal(size=(K, n)).astype(np.float32), \
        rng.dirichlet([1.0] * K).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_agg_kernel_matches_plain_version(cuda, dtype):
    """Ragged N (1, 7, 5000, 20,490 are not multiples of 8) ends in the
    element-wise tail; 128 and 2048 are whole 16-byte vectors.  A group of
    one leaf, one launch, bit-equal to the plain version."""
    for K in (1, 2, 5, 8):
        for n in (1, 7, 128, 2048, 5000, 20_490):
            x, w = _inputs(K, n)
            xt = torch.from_numpy(x).to(cuda, dtype)
            before = tkernel.fed_agg_grouped_cuda.launches
            got = fed_agg(xt, w)
            torch.cuda.synchronize()
            assert tkernel.fed_agg_grouped_cuda.launches == before + 1
            assert got.dtype == dtype and got.shape == (n,)
            assert torch.equal(got, fed_agg_2d_ref(xt, torch.from_numpy(w)))


def test_fed_agg_kernel_unaligned_rows(cuda):
    """x starting 4 bytes past a 16-byte boundary must not take the
    vector path."""
    x, w = _inputs(3, 1025)
    base = torch.from_numpy(x).to(cuda).reshape(-1)
    xt = base[1:1 + 3 * 1024].reshape(3, 1024)     # N % 4 == 0, unaligned
    assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    got = tkernel.fed_agg_cuda(xt, w)
    torch.cuda.synchronize()
    assert torch.equal(got, fed_agg_2d_ref(xt, torch.from_numpy(w)))


def test_fed_agg_kernel_rejects_what_it_does_not_take(cuda):
    """fp16, a non-contiguous member, too few weights, weights on the card
    (they are passed by value), leaves of differing shape or device: each
    refused before any launch."""
    x, w = _inputs(2, 64)
    xt = torch.from_numpy(x).to(cuda)
    before = tkernel.fed_agg_grouped_cuda.launches
    with pytest.raises(TypeError):
        tkernel.fed_agg_cuda(xt.half(), w)
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(xt.t(), w)
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(xt, w[:1])
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(xt, torch.from_numpy(w).to(cuda))
    with pytest.raises(ValueError):
        tkernel.fed_agg_grouped_cuda([[xt[0]], [xt[1, :32]]], w)
    with pytest.raises(ValueError):
        tkernel.fed_agg_grouped_cuda([[xt[0]], [xt[1].cpu()]], w)
    assert tkernel.fed_agg_grouped_cuda.launches == before


def _grouped_held(members, w, launches):
    """The grouped kernel over members[k][l], bit-equal to the plain
    version leaf by leaf, in `launches` launches."""
    from repro_torch.kernels.fed_agg.ref import fed_agg_grouped_ref
    before = tkernel.fed_agg_grouped_cuda.launches
    got = tkernel.fed_agg_grouped_cuda(members, w)
    torch.cuda.synchronize()
    assert tkernel.fed_agg_grouped_cuda.launches - before == launches
    want = fed_agg_grouped_ref(members, w)
    for g, x, leaf in zip(got, want, members[0]):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        assert torch.equal(g, x), (tuple(leaf.shape), leaf.dtype)


def _tree(rng, cuda, shapes):
    """A member's leaves: (shape, dtype) normal fp32 values cast."""
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda, dt) for s, dt in shapes]


def test_fed_agg_grouped_bit_equal_over_trees(cuda):
    """Mixed fp32 / bf16 trees (one launch whatever the dtypes), leaves
    that start off a 16-byte boundary among aligned ones, K = 1, and K = 2
    over flight-cnn-mnist's own leaf shapes (the async merge)."""
    rng = np.random.default_rng(11)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [((33, 7), f32), ((130,), bf16), ((4, 5, 6), f32), ((1,), bf16),
              ((5000,), f32), ((2048,), bf16), ((3, 1025), f32)]
    for K in (1, 2, 5):
        members = [_tree(rng, cuda, shapes) for _ in range(K)]
        _grouped_held(members, rng.dirichlet([1.0] * K), 1)
    # unaligned leaves: views 4 and 2 bytes past a boundary
    members = []
    for _ in range(3):
        flat = torch.from_numpy(rng.normal(size=4100).astype(
            np.float32)).to(cuda)
        half = flat.to(bf16)
        members.append([flat[1:1 + 4096], half[1:1 + 1000], flat[8:8 + 64]])
    assert members[0][0].data_ptr() % 16 and members[0][1].data_ptr() % 16
    _grouped_held(members, [0.2, 0.3, 0.5], 1)
    from repro_torch import threefry
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cnn = build_model(get_config("flight-cnn-mnist")).init(threefry.key(0),
                                                           cuda)
    cnn_shapes = [(tuple(l.shape), l.dtype) for l in leaves(cnn)]
    members = [_tree(rng, cuda, cnn_shapes) for _ in range(2)]
    _grouped_held(members, [0.65, 0.35], 1)


def test_fed_agg_grouped_capacity_edge(cuda):
    """A tree of exactly capacity() slots is one launch; one member more
    puts its last leaf into a second launch; a leaf with more members than
    a launch holds carries an fp32 partial sum between launches in k order
    and stays bit-equal."""
    slots, parts = tkernel.capacity()
    rng = np.random.default_rng(12)
    L = 16
    shapes = [((3 + 100 * l,), torch.float32 if l % 3 else torch.bfloat16)
              for l in range(L)]
    K = slots // L
    members = [_tree(rng, cuda, shapes) for _ in range(K + 1)]
    w = rng.dirichlet([1.0] * (K + 1))
    _grouped_held(members[:K], w[:K] / w[:K].sum(), 1)
    _grouped_held(members, w, 2)
    big = [_tree(rng, cuda, [((2000,), torch.bfloat16), ((70,), torch.float32)])
           for _ in range(slots + 5)]
    wb = rng.dirichlet([1.0] * len(big))
    _grouped_held(big, wb, 4)     # each leaf: 2,048 members, then 5
    assert parts >= L and slots >= 2048


def test_tree_merge_is_one_launch(cuda):
    """A weighted average of 5 trees is one launch; one async_merge on
    flight-cnn-mnist's tree runs exactly one CUDA kernel on the device and
    no memcpy or memset (the weights go by value, no torch.cat)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    trees = [from_reference({"a": rng.normal(size=(33, 7)).astype(np.float32),
                             "b": rng.normal(size=(130,)).astype(np.float32)},
                            cuda) for _ in range(5)]
    w = np.full(5, 0.2)
    before = tkernel.fed_agg_grouped_cuda.launches
    got = tagg.weighted_average(trees, w)
    assert tkernel.fed_agg_grouped_cuda.launches == before + 1
    want = tagg.weighted_average(trees, w, impl="ref")
    for g, x in zip(leaves(got), leaves(want)):
        assert torch.equal(g, x)
    from repro_torch import threefry
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("flight-cnn-mnist"))
    server, worker = (model.init(threefry.key(s), cuda) for s in (0, 1))
    tagg.async_merge(server, worker, 0.3)          # warm: the library built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        merged = tagg.async_merge(server, worker, 0.3)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.key for e in device]
    assert sum(e.count for e in device) == 1, names      # no copy, no cat
    assert "fed_agg_grouped" in names[0], names
    host = [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    # no copy to or from the card, no wait on a stream (the test's own
    # torch.cuda.synchronize is a device synchronise, after the merge)
    assert not any("memcpy" in n.lower() or "memset" in n.lower()
                   or "streamsynchronize" in n.lower()
                   or "eventsynchronize" in n.lower() for n in host), host
    want = tagg.async_merge(server, worker, 0.3, impl="ref")
    for g, x in zip(leaves(merged), leaves(want)):
        assert torch.equal(g, x)


def test_paper_suite_and_resume_launch_once_per_merge(cuda, tmp_path):
    """A 2-round fig17 (the sequential, random and Alg. 2 sync fleets) and
    a crashed-and-resumed async run on the card: one fed_agg launch per
    merge, where a run's merges are its last record's server version; the
    resumed run still equals the uninterrupted one, params bit for bit."""
    from repro_torch.examples import resume
    from repro_torch.examples.paper import fig17_alg2_sync
    from repro_torch.examples.paper.common import recorded_results
    before = tkernel.fed_agg_grouped_cuda.launches
    with recorded_results() as results:
        fig17_alg2_sync.main(rounds=2, seed=0, device="cuda")
    merges = sum(r.records[-1].version for r in results)
    assert len(results) == 3 and merges > 0
    assert tkernel.fed_agg_grouped_cuda.launches - before == merges
    before = tkernel.fed_agg_grouped_cuda.launches
    ref, killed, resumed, merges = resume.crash_and_resume(
        "async", tmp_path, "cuda")
    assert resume.holds(ref, killed, resumed)
    assert tkernel.fed_agg_grouped_cuda.launches - before == merges


def _rows(R, C, seed, cuda, dtype):
    """Normal rows over four decades of scale; rows 0-3 (when present)
    hold a NaN, a +inf, a -inf, and zeros only."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, C)) * 10.0 ** rng.uniform(-2, 2, size=(R, 1))
    for r, (c, v) in enumerate([(C // 2, np.nan), (C - 1, np.inf),
                                (0, -np.inf)][:R]):
        x[r, c] = v
    if R > 3:
        x[3] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(cuda, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(9, 1), (64, 5), (7, 31), (33, 256),
                                 (5, 1027), (4, 4096), (3, 151_936),
                                 (3, 50_257), (300, 8200)])
def test_quant8_kernels_bit_equal_plain_version(cuda, dtype, R, C):
    """Short rows (a lane group each, C = 1, 5, 31 leave lanes idle), the
    1027-wide bias, rows too wide to hold: the 151,936-wide LM-head row
    and an odd 50,257-wide one (several blocks a row), 300 rows of 8,200
    (one block a row); q and scales bit-equal, NaN/inf rows with q = 0
    and a non-finite scale; dequantise bit-equal in fp32 and bf16."""
    x = _rows(R, C, R * C, cuda, dtype)
    before = (q8kernel.quantize_grouped_cuda.launches,
              q8kernel.dequantize_grouped_cuda.launches)
    q, s = q8ops.quantize_rows(x)
    qr, sr = quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert q8kernel.quantize_grouped_cuda.launches == before[0] + 1
    assert torch.equal(q, qr)
    torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
    bad = min(R, 3)
    assert not q[:bad].any() and not torch.isfinite(s[:bad]).any()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = q8ops.dequantize_rows(q, s, out_dtype=out_dtype)
        torch.testing.assert_close(got, dequantize_rows_ref(q, s, out_dtype),
                                   rtol=0, atol=0, equal_nan=True)
    assert q8kernel.dequantize_grouped_cuda.launches == before[1] + 2


def test_quant8_dequantize_past_two_to_the_31_elements(cuda):
    """Past 2^31 elements dequantise takes 64-bit indices: both rows at
    their ends and row 1 around the 2^31-th element, bit-equal to the
    plain version."""
    C = (1 << 30) + 3
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randint(-127, 128, (2, C), dtype=torch.int8, device=cuda,
                      generator=g)
    s = torch.tensor([[0.5], [3.0e-3]], device=cuda)
    out = q8kernel.dequantize_rows_cuda(q, s, torch.bfloat16)
    mid = (1 << 31) - C            # row 1's column of element 2^31
    for r, lo, hi in ((0, 0, 4096), (0, C - 4096, C), (1, 0, 4096),
                      (1, mid - 2048, mid + 2048), (1, C - 4096, C)):
        want = dequantize_rows_ref(q[r:r + 1, lo:hi], s[r:r + 1],
                                   torch.bfloat16)
        torch.testing.assert_close(out[r:r + 1, lo:hi], want, rtol=0,
                                   atol=0)


def test_quant8_kernels_reject_what_they_do_not_take(cuda):
    x = torch.ones(4, 8, device=cuda)
    before = (q8kernel.quantize_grouped_cuda.launches,
              q8kernel.dequantize_grouped_cuda.launches)
    with pytest.raises(TypeError):
        q8kernel.quantize_rows_cuda(x.half())
    with pytest.raises(ValueError):
        q8kernel.quantize_rows_cuda(x.t())
    q, s = q8kernel.quantize_rows_cuda(x)
    with pytest.raises(ValueError):
        q8kernel.dequantize_rows_cuda(q, s[:2])
    with pytest.raises(TypeError):
        q8kernel.dequantize_rows_cuda(q.int(), s)
    assert (q8kernel.quantize_grouped_cuda.launches,
            q8kernel.dequantize_grouped_cuda.launches) == (before[0] + 1,
                                                        before[1])


def _mixed(cuda, dtype, seed):
    """A mixed leaf list: C = 5 beside 1,027, a one-row leaf, the 256-wide
    exchange rows, the int8 cache's 128, a 4,096 row (one block), a
    151,936 row and an odd 50,257 one (streamed), a C = 1 leaf and an
    empty one; NaN/inf rows in every leaf of four rows or more."""
    shapes = [(64, 5), (5, 1027), (1, 256), (33, 256), (70, 128), (4, 4096),
              (2, 151_936), (9, 1), (0, 64), (1, 1027), (300, 1024),
              (3, 50_257)]
    return [_rows(R, C, seed + i, cuda, dtype)
            for i, (R, C) in enumerate(shapes)]


def _held_grouped(xs, out_dtype, poisoned=True):
    qss = q8kernel.quantize_grouped_cuda(xs)
    outs = q8kernel.dequantize_grouped_cuda([q for q, _ in qss],
                                            [s for _, s in qss], out_dtype)
    torch.cuda.synchronize()
    assert len(qss) == len(outs) == len(xs)
    for x, (q, s), out in zip(xs, qss, outs):
        qr, sr = quantize_rows_ref(x)
        assert torch.equal(q, qr), tuple(x.shape)
        torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(out, dequantize_rows_ref(q, s, out_dtype),
                                   rtol=0, atol=0, equal_nan=True)
        if poisoned:      # _rows' NaN/inf rows: q 0, scale not finite
            bad = min(x.shape[0], 3)
            assert not q[:bad].any() and not torch.isfinite(s[:bad]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant8_grouped_kernels_bit_equal_plain_version(cuda, dtype):
    """One grouped launch over a mixed list holds every leaf bit for bit
    against the plain version, in both output dtypes; so do leaves that
    start off a 16-byte boundary (the element-wise paths), a 151,936-wide
    row among them."""
    xs = _mixed(cuda, dtype, 1)
    for out_dtype in (torch.float32, torch.bfloat16):
        _held_grouped(xs, out_dtype)
    base = _rows(3, 4 * 1024 + 8, 7, cuda, dtype).reshape(-1)
    wide = _rows(3, 151_937, 8, cuda, dtype).reshape(-1)
    _held_grouped([base[1:1 + 4096].reshape(4, 1024),
                   base[2:2 + 3 * 256].reshape(3, 256),
                   wide[1:1 + 2 * 151_936].reshape(2, 151_936)], dtype,
                  poisoned=False)


def test_quant8_grouped_launches_per_capacity(cuda):
    """A list of n leaves is ceil(n / capacity) launches of each kernel,
    every leaf still bit-equal; an empty list or empty leaves launch
    nothing."""
    cap = q8kernel.capacity()
    for n in (1, cap - 1, cap, cap + 1, 2 * cap + 3):
        xs = [_rows(1 + i % 5, 5 + 37 * (i % 7), 100 + i, cuda,
                    torch.float32) for i in range(n)]
        before = (q8kernel.quantize_grouped_cuda.launches,
                  q8kernel.dequantize_grouped_cuda.launches)
        _held_grouped(xs, torch.float32)
        want = -(-n // cap)
        assert (q8kernel.quantize_grouped_cuda.launches - before[0],
                q8kernel.dequantize_grouped_cuda.launches - before[1]) \
            == (want, want)
    before = q8kernel.quantize_grouped_cuda.launches
    assert q8kernel.quantize_grouped_cuda([]) == []
    q, s = q8kernel.quantize_rows_cuda(torch.empty(0, 8, device=cuda))
    assert q.shape == (0, 8) and s.shape == (0, 1)
    assert q8kernel.quantize_grouped_cuda.launches == before


def test_quant8_grouped_kernels_refuse_bad_leaves(cuda):
    """Each bad leaf in a list is refused before any launch: a leaf on
    another device, a non-contiguous leaf, fp16, a dtype differing from
    the list's, a row of 2^30 or more to quantise, a scale of the wrong
    shape or dtype."""
    x = torch.ones(4, 8, device=cuda)
    before = (q8kernel.quantize_grouped_cuda.launches,
              q8kernel.dequantize_grouped_cuda.launches)
    with pytest.raises(ValueError):
        q8kernel.quantize_grouped_cuda([x, x.cpu()])
    with pytest.raises(ValueError):
        q8kernel.quantize_grouped_cuda([x, x.t()])
    with pytest.raises(TypeError):
        q8kernel.quantize_grouped_cuda([x, x.half()])
    with pytest.raises(TypeError):
        q8kernel.quantize_grouped_cuda([x, x.to(torch.bfloat16)])
    with pytest.raises(ValueError):
        q8kernel.quantize_grouped_cuda([x, x.reshape(-1)])
    with pytest.raises(ValueError):       # a row of 2^30: past 32-bit columns
        q8kernel.quantize_grouped_cuda(
            [torch.empty(1, 1 << 30, dtype=torch.bfloat16, device=cuda)])
    (q, s), = q8kernel.quantize_grouped_cuda([x])
    with pytest.raises(ValueError):
        q8kernel.dequantize_grouped_cuda([q, q], [s, s[:2]])
    with pytest.raises(ValueError):
        q8kernel.dequantize_grouped_cuda([q, q], [s, s.reshape(-1)])
    with pytest.raises(TypeError):
        q8kernel.dequantize_grouped_cuda([q, q], [s, s.double()])
    with pytest.raises(ValueError):
        q8kernel.dequantize_grouped_cuda([q, q.cpu()], [s, s.cpu()])
    with pytest.raises(ValueError):
        q8kernel.dequantize_grouped_cuda([q, q], [s])
    with pytest.raises(TypeError):
        q8kernel.dequantize_grouped_cuda([q], [s], torch.float16)
    assert (q8kernel.quantize_grouped_cuda.launches,
            q8kernel.dequantize_grouped_cuda.launches) == (before[0] + 1,
                                                          before[1])


def test_flat_q8_exchange_is_two_launches_and_equals_plain(cuda):
    """The exchange workload at P = 2: 5 leaves in one grouped quantise
    and one grouped dequantise, 1 + 1 launches (ten before the kernels
    took a leaf list); the kernel exchange equals the plain one
    exactly."""
    stacked, base = fl_exchange.make_tree(2, device=cuda)
    before = (q8kernel.quantize_grouped_cuda.launches,
              q8kernel.dequantize_grouped_cuda.launches)
    got = fl_exchange.exchange_fn(2, "q8", device=cuda)(stacked, base)
    assert (q8kernel.quantize_grouped_cuda.launches - before[0],
            q8kernel.dequantize_grouped_cuda.launches - before[1]) == (1, 1)
    want = fl_exchange.exchange_fn(2, "q8", impl="ref", device=cuda)(
        stacked, base)
    assert fl_exchange.max_abs_diff(got, want) == 0.0


# -- flash_attention (the LM slice) ------------------------------------------

FA_SHAPES = [  # (B, T, H, Hkv, D, window, causal)
    (2, 256, 4, 4, 64, 0, True), (2, 256, 4, 2, 64, 0, True),
    (2, 512, 8, 1, 128, 0, True), (2, 512, 4, 2, 64, 128, True),
    (2, 1024, 2, 2, 64, 300, True), (1, 1, 4, 1, 8, 0, True),
    (2, 77, 4, 2, 12, 0, True), (1, 1000, 8, 2, 16, 0, True),
    (2, 77, 4, 4, 16, 0, False), (1, 130, 48, 1, 128, 0, True),
    (1, 300, 4, 1, 256, 0, True), (1, 130, 3, 3, 200, 50, False),
    # bf16 takes the wgmma route on all below: a tail tile of one key at
    # D = 128, D = 256 under a window that is no multiple of a tile, D =
    # 200 padded to 256, GQA groups of 1, 2 and 48
    (1, 4097, 4, 1, 128, 0, True), (2, 700, 4, 1, 256, 300, True),
    (1, 300, 4, 2, 200, 0, True), (2, 333, 4, 4, 128, 0, True),
    (1, 520, 48, 1, 128, 0, True), (1, 200, 4, 2, 256, 0, False)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_matches_plain_version(cuda, dtype, tol):
    """Odd T (1, 77, 130, 1000), MQA with granite's group of 48, windows,
    non-causal, D from 8 to 256; tolerances of tests/test_kernels.py."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, T, H, Hkv, D, window, causal in FA_SHAPES:
        q = (torch.randn(B, T, H, D, generator=g, device=cuda) * 0.3).to(dtype)
        k = (torch.randn(B, T, Hkv, D, generator=g, device=cuda) * 0.3
             ).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=g, device=cuda).to(dtype)
        before = fa.flash_attention_cuda.launches
        route = fa.route(q, k, v)
        on_route = fa.flash_attention_cuda.routes[route]
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
        torch.cuda.synchronize()
        assert fa.flash_attention_cuda.launches == before + 1
        assert fa.flash_attention_cuda.routes[route] == on_route + 1
        assert route == ("fma" if dtype == torch.float32 else
                         "wgmma" if D % 8 == 0 else "mma")
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_flash_attention_kernel_takes_strided_views(cuda):
    """q/k/v as the projections leave them (views of wider tensors): the
    kernel reads them through their strides, with no copy."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 96, 6, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("D,route", [(64, "wgmma"), (128, "wgmma"),
                                     (256, "wgmma"), (200, "wgmma"),
                                     (12, "mma"), (200, "fma")])
def test_flash_attention_routes_on_strided_views(cuda, D, route):
    """bf16 q/k/v as views of one fused projection, read through their
    strides on the route their layout gets: TMA takes strides that are
    multiples of 8 elements (a row padded to D + 8), mma.sync and the FMA
    kernel the others (a row padded by one element)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda).manual_seed(2)
    pad = 1 if route != "wgmma" else 8
    qkv = torch.randn(2, 300, 6, D + pad, generator=g, device=cuda)
    qkv = (qkv * 0.3).to(torch.bfloat16)[..., :D]
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    assert fa.route(q, k, v) == route
    before = fa.flash_attention_cuda.routes[route]
    got = fa.flash_attention_cuda(q, k, v, window=100)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window=100).transpose(1, 2)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.routes[route] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_kernel_refuses_a_route_it_cannot_take(cuda):
    """The C entry point refuses wgmma on a layout TMA cannot describe and
    mma above D = 128 (cudaErrorInvalidValue), rather than run another
    kernel."""
    import math
    from repro_torch.kernels.flash_attention import kernel as fa
    lib = fa.library()
    q = torch.zeros(1, 16, 2, 12, device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros(1, 16, 2, 256, device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(wide)
    stream = torch.cuda.current_stream().cuda_stream
    for t, name in ((q, "wgmma"), (wide, "mma"), (wide.float(), "wgmma")):
        err = lib.flash_attention_fwd(
            t.data_ptr(), t.data_ptr(), t.data_ptr(), out.data_ptr(), 1, 16,
            2, 2, t.shape[3], *(t.stride()[:3] * 3), 1, 0,
            1.0 / math.sqrt(t.shape[3]), int(t.dtype == torch.bfloat16),
            fa.ROUTES.index(name), stream)
        assert err != 0, (tuple(t.shape), t.dtype, name)


def test_flash_attention_kernel_refuses_cross_attention(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    k = torch.zeros(1, 9, 2, 16, device=cuda)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="S = 9"):
        fa.flash_attention_cuda(q, k, k)
    assert fa.flash_attention_cuda.launches == before


@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b",
                                  "recurrentgemma-9b"])
def test_one_flash_launch_per_layer_per_prefill(cuda, arch):
    """Prefill and train launch the kernel once per attention layer, all on
    the wgmma route (head dims 16, 8, 16); decode never.  The logits agree
    with the plain version's run."""
    from repro_torch import threefry
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import build_model
    from repro_torch.models.rglru import hybrid_counts
    model = build_model(get_smoke_config(arch))
    params = model.init(threefry.key(0), cuda)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 37), device=cuda,
                         dtype=torch.int32)
    L = hybrid_counts(model.cfg)[0] if model.cfg.family == "hybrid" \
        else model.cfg.num_layers
    before = fa.flash_attention_cuda.launches
    on_wgmma = fa.flash_attention_cuda.routes["wgmma"]
    with torch.no_grad():
        logits, cache = model.apply(params, {"tokens": toks}, mode="prefill")
        assert fa.flash_attention_cuda.launches == before + L
        assert fa.flash_attention_cuda.routes["wgmma"] == on_wgmma + L
        plain, _ = model.apply(params, {"tokens": toks}, mode="prefill",
                               impl="ref")
        assert fa.flash_attention_cuda.launches == before + L
        model.apply(params, {"tokens": toks[:, :1]}, mode="decode",
                    cache=cache)
        assert fa.flash_attention_cuda.launches == before + L
        model.apply(params, {"tokens": toks}, mode="train")
        assert fa.flash_attention_cuda.launches == before + 2 * L
    torch.testing.assert_close(logits.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)


def test_serve_loop_on_card_matches_solo(cuda):
    """Continuous batching on the card, granite smoke with an int8 cache
    (quant8 kernels in the cache path): token-identical to solo serving."""
    import dataclasses
    from repro_torch import threefry
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve_loop import Request, ServeLoop
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config("granite-20b"),
                              cache_spec="head/int8")
    model = build_model(cfg)
    params = model.init(threefry.key(0), cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7, 19)]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    want = []
    for p in prompts:
        nxt, cache = prefill(params, {"tokens": torch.as_tensor(
            p[None], device=cuda)})
        out = [int(nxt[0])]
        for pos in range(len(p), len(p) + 5):
            nxt, cache = decode(params, {
                "tokens": nxt[:, None],
                "positions": torch.full((1, 1), pos, dtype=torch.int32,
                                        device=cuda)}, cache)
            out.append(int(nxt[0]))
        want.append(out)
    q_before = q8kernel.quantize_grouped_cuda.launches
    loop = ServeLoop(model, params, max_batch=2, max_len=128)
    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new=6))
    done = {r.rid: r.out for r in loop.run_until_drained()}
    assert [done[i] for i in range(3)] == want
    assert q8kernel.quantize_grouped_cuda.launches > q_before


# linrec: (B, T, D) with odd T and D, with and without a starting state
LINREC_SHAPES = [(1, 128, 128), (2, 512, 640), (3, 256, 512), (2, 1, 12),
                 (2, 77, 130), (1, 1000, 12), (4, 33, 4096)]
# recurrentgemma-9b's and falcon-mamba-7b's prefill scans at B = 1, and a
# falcon decode step
LINREC_MAIN = [(1, 2048, 4096), (1, 2048, 8192 * 16), (1, 1, 8192 * 16)]


def _linrec_routes(a, b):
    """The routes the kernel can take these inputs on: column always, tma
    where TMA can describe them."""
    from repro_torch.kernels.linrec import kernel as lr
    return ("column", "tma") if lr.tma_ok(a, b) else ("column",)


def _linrec_held(a, b, h0):
    """Both routes (where they take the inputs) equal ref.py bit for bit;
    each launch counted on its route; -> the routes taken."""
    from repro_torch.kernels.linrec import kernel as lr
    from repro_torch.kernels.linrec.ref import linrec_ref
    want = linrec_ref(a, b, h0)
    routes = _linrec_routes(a, b)
    for name in routes:
        before = dict(lr.linrec_cuda.routes)
        got = lr.linrec_cuda(a, b, h0, route_name=name)
        torch.cuda.synchronize()
        assert lr.linrec_cuda.routes[name] == before[name] + 1
        assert got.dtype == torch.float32 and got.shape == a.shape
        assert torch.equal(got, want), (name, tuple(a.shape), h0 is None)
    return routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linrec_kernel_equals_plain_version(cuda, dtype):
    """One product and one sum a step, each rounded, in both: each route
    of the kernel equals ref.py bit for bit (test_kernels.py's 2e-4 /
    3e-2 would do), over odd shapes and the models' main shapes at B = 1,
    from zeros and from an h0; ops.linrec takes the route kernel.route
    picks."""
    from repro_torch.kernels.linrec import kernel as lr
    from repro_torch.kernels.linrec.ops import linrec
    g = torch.Generator(device=cuda).manual_seed(0)
    taken = set()
    for B, T, D in LINREC_SHAPES + LINREC_MAIN:
        a = (0.7 + 0.299 * torch.rand(B, T, D, generator=g, device=cuda)
             ).to(dtype)
        b = (0.1 * torch.randn(B, T, D, generator=g, device=cuda)).to(dtype)
        for h0 in (None, torch.randn(B, D, generator=g, device=cuda)):
            taken.update(_linrec_held(a, b, h0))
            before = dict(lr.linrec_cuda.routes)
            got = linrec(a, b, h0)
            want = lr.route(a, b)
            assert lr.linrec_cuda.routes[want] == before[want] + 1
            assert torch.equal(got, linrec(a, b, h0, impl="ref"))
    assert taken == {"column", "tma"}
    for B, T, D in LINREC_MAIN[:2]:
        a = torch.empty(B, T, D, device=cuda, dtype=dtype)
        assert lr.route(a, a) == "tma"
    assert lr.route(*(torch.empty(LINREC_MAIN[2], device=cuda),) * 2) \
        == "column"


def test_linrec_kernel_takes_strided_views(cuda):
    """a and b as views along batch and time (d contiguous): read through
    their strides, as the (B, T, di, N) -> (B, T, di * N) view is; on the
    tma route where the strides are multiples of 16 bytes, on the column
    route where they are not."""
    from repro_torch.kernels.linrec import kernel as lr
    g = torch.Generator(device=cuda).manual_seed(1)
    ab = torch.rand(3, 50, 2, 40, generator=g, device=cuda)
    a, b = ab[:, :, 0], ab[:, :, 1]                     # (3, 50, 40) views
    assert not a.is_contiguous()
    assert _linrec_held(a, b, None) == ("column", "tma")
    ab = torch.rand(2, 300, 2, 1024, generator=g, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        c = ab.to(dtype)
        a, b = c[:, :, 0], c[:, :, 1]
        assert lr.route(a, b) == "tma"
        _linrec_held(a, b, torch.randn(2, 1024, generator=g, device=cuda))
    odd = torch.rand(2, 64, 2, 130, generator=g, device=cuda)
    assert _linrec_held(odd[:, :, 0], odd[:, :, 1], None) == ("column",)


def test_linrec_kernel_rejects_what_it_does_not_take(cuda):
    """Bad dtypes, a non-contiguous d, a wrong h0, an unknown route, and
    the tma route on a layout TMA cannot describe: each refused, nothing
    counted."""
    from repro_torch.kernels.linrec import kernel as lr
    a = torch.rand(2, 8, 16, device=cuda)
    before = lr.linrec_cuda.launches, dict(lr.linrec_cuda.routes)
    with pytest.raises(TypeError):
        lr.linrec_cuda(a, a.half())
    with pytest.raises(ValueError, match="contiguous"):
        lr.linrec_cuda(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        lr.linrec_cuda(a, a, torch.zeros(2, 15, device=cuda))
    with pytest.raises(ValueError, match="route"):
        lr.linrec_cuda(a, a, route_name="pallas")
    odd = torch.rand(2, 64, 130, device=cuda)
    with pytest.raises(RuntimeError, match="tma"):
        lr.linrec_cuda(odd, odd, route_name="tma")
    assert (lr.linrec_cuda.launches, lr.linrec_cuda.routes) == before


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_one_linrec_launch_per_recurrent_layer(cuda, arch):
    """Prefill and each decode step launch linrec once per recurrent layer
    (the hybrid's attention layers launch flash in prefill); the plain
    run launches nothing, and its logits agree with the kernels'."""
    from repro_torch import threefry
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.linrec import kernel as lr
    from repro_torch.models import build_model
    from repro_torch.models.rglru import hybrid_counts
    model = build_model(get_smoke_config(arch))
    params = model.init(threefry.key(0), cuda)
    if arch == "falcon-mamba-7b":
        n_rec, n_attn = model.cfg.num_layers, 0
    else:
        n_super, n_tail = hybrid_counts(model.cfg)
        n_rec, n_attn = 2 * n_super + n_tail, n_super
    # its own generator: the same tokens whatever ran before
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 37), generator=g,
                         device=cuda, dtype=torch.int32)
    lr0, fa0 = lr.linrec_cuda.launches, fa.flash_attention_cuda.launches
    with torch.no_grad():
        logits, cache = model.apply(params, {"tokens": toks}, mode="prefill")
        assert lr.linrec_cuda.launches == lr0 + n_rec
        assert fa.flash_attention_cuda.launches == fa0 + n_attn
        plain, _ = model.apply(params, {"tokens": toks}, mode="prefill",
                               impl="ref")
        assert lr.linrec_cuda.launches == lr0 + n_rec
        model.apply(params, {"tokens": toks[:, :1]}, mode="decode",
                    cache=cache)
        assert lr.linrec_cuda.launches == lr0 + 2 * n_rec
        assert fa.flash_attention_cuda.launches == fa0 + n_attn
    torch.testing.assert_close(logits.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)


def test_ssm_serve_loop_on_card_matches_solo(cuda):
    """falcon-mamba smoke in a 2-slot ServeLoop on the card, a 2-token
    prompt among them: token-identical to solo serving."""
    from repro_torch import threefry
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve_loop import Request, ServeLoop
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    model = build_model(get_smoke_config("falcon-mamba-7b"))
    params = model.init(threefry.key(0), cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 2, 19)]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    want = []
    for p in prompts:
        nxt, cache = prefill(params, {"tokens": torch.as_tensor(
            p[None], device=cuda)})
        out = [int(nxt[0])]
        for pos in range(len(p), len(p) + 5):
            nxt, cache = decode(params, {
                "tokens": nxt[:, None],
                "positions": torch.full((1, 1), pos, dtype=torch.int32,
                                        device=cuda)}, cache)
            out.append(int(nxt[0]))
        want.append(out)
    loop = ServeLoop(model, params, max_batch=2, max_len=64)
    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new=6))
    done = {r.rid: r.out for r in loop.run_until_drained()}
    assert [done[i] for i in range(3)] == want
