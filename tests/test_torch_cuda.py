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
from repro_torch.kernels.fed_agg import kernel as tkernel
from repro_torch.kernels.fed_agg.ops import fed_agg
from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref
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
