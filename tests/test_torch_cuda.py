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
    """Ragged N (1, 7, 5000, 20,490 are not multiples of 8) takes the
    masked element-wise path; 128 and 2048 the 16-byte vector path."""
    for K in (1, 2, 5, 8):
        for n in (1, 7, 128, 2048, 5000, 20_490):
            x, w = _inputs(K, n)
            xt = torch.from_numpy(x).to(cuda, dtype)
            wt = torch.from_numpy(w).to(cuda)
            before = tkernel.fed_agg_cuda.launches
            got = fed_agg(xt, wt)
            torch.cuda.synchronize()
            assert tkernel.fed_agg_cuda.launches == before + 1
            assert got.dtype == dtype and got.shape == (n,)
            torch.testing.assert_close(got.float(),
                                       fed_agg_2d_ref(xt, wt).float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])


def test_fed_agg_kernel_unaligned_rows(cuda):
    """x starting 4 bytes past a 16-byte boundary must not take the
    vector path."""
    x, w = _inputs(3, 1025)
    base = torch.from_numpy(x).to(cuda).reshape(-1)
    xt = base[1:1 + 3 * 1024].reshape(3, 1024)     # N % 4 == 0, unaligned
    assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    wt = torch.from_numpy(w).to(cuda)
    got = tkernel.fed_agg_cuda(xt, wt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fed_agg_2d_ref(xt, wt), rtol=1e-5,
                               atol=1e-5)


def test_fed_agg_kernel_rejects_what_it_does_not_take(cuda):
    x, w = _inputs(2, 64)
    wt = torch.from_numpy(w).to(cuda)
    before = tkernel.fed_agg_cuda.launches
    with pytest.raises(TypeError):
        tkernel.fed_agg_cuda(torch.from_numpy(x).to(cuda, torch.float16), wt)
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(torch.from_numpy(x).to(cuda).t(), wt)
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(torch.from_numpy(x).to(cuda), wt[:1])
    assert tkernel.fed_agg_cuda.launches == before


def test_tree_merge_is_one_launch(cuda):
    rng = np.random.default_rng(4)
    trees = [from_reference({"a": rng.normal(size=(33, 7)).astype(np.float32),
                             "b": rng.normal(size=(130,)).astype(np.float32)},
                            cuda) for _ in range(5)]
    w = np.full(5, 0.2)
    before = tkernel.fed_agg_cuda.launches
    got = tagg.weighted_average(trees, w)
    assert tkernel.fed_agg_cuda.launches == before + 1
    want = tagg.weighted_average(trees, w, impl="ref")
    for g, x in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(g, x, rtol=1e-6, atol=1e-6)


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
                                 (5, 1027), (4, 4096), (3, 151_936)])
def test_quant8_kernels_bit_equal_plain_version(cuda, dtype, R, C):
    """Short rows (a lane group each, C = 1, 5, 31 leave lanes idle), the
    1027-wide bias and the 151,936-wide LM-head row (one block each); q
    and scales bit-equal, NaN/inf rows with q = 0 and a non-finite
    scale; dequantise bit-equal in fp32 and bf16."""
    x = _rows(R, C, R * C, cuda, dtype)
    before = (q8kernel.quantize_rows_cuda.launches,
              q8kernel.dequantize_rows_cuda.launches)
    q, s = q8ops.quantize_rows(x)
    qr, sr = quantize_rows_ref(x)
    torch.cuda.synchronize()
    assert q8kernel.quantize_rows_cuda.launches == before[0] + 1
    assert torch.equal(q, qr)
    torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
    bad = min(R, 3)
    assert not q[:bad].any() and not torch.isfinite(s[:bad]).any()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = q8ops.dequantize_rows(q, s, out_dtype=out_dtype)
        torch.testing.assert_close(got, dequantize_rows_ref(q, s, out_dtype),
                                   rtol=0, atol=0, equal_nan=True)
    assert q8kernel.dequantize_rows_cuda.launches == before[1] + 2


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
    before = (q8kernel.quantize_rows_cuda.launches,
              q8kernel.dequantize_rows_cuda.launches)
    with pytest.raises(TypeError):
        q8kernel.quantize_rows_cuda(x.half())
    with pytest.raises(ValueError):
        q8kernel.quantize_rows_cuda(x.t())
    q, s = q8kernel.quantize_rows_cuda(x)
    with pytest.raises(ValueError):
        q8kernel.dequantize_rows_cuda(q, s[:2])
    with pytest.raises(TypeError):
        q8kernel.dequantize_rows_cuda(q.int(), s)
    assert (q8kernel.quantize_rows_cuda.launches,
            q8kernel.dequantize_rows_cuda.launches) == (before[0] + 1,
                                                        before[1])


def test_flat_q8_exchange_is_ten_launches_and_equals_plain(cuda):
    """The exchange workload at P = 2: 5 leaves, one quantise and one
    dequantise each; the kernel exchange equals the plain one exactly."""
    stacked, base = fl_exchange.make_tree(2, device=cuda)
    before = (q8kernel.quantize_rows_cuda.launches,
              q8kernel.dequantize_rows_cuda.launches)
    got = fl_exchange.exchange_fn(2, "q8", device=cuda)(stacked, base)
    assert (q8kernel.quantize_rows_cuda.launches - before[0],
            q8kernel.dequantize_rows_cuda.launches - before[1]) == (5, 5)
    want = fl_exchange.exchange_fn(2, "q8", impl="ref", device=cuda)(
        stacked, base)
    assert fl_exchange.max_abs_diff(got, want) == 0.0
