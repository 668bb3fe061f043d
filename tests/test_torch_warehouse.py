"""The port's data warehouse (`repro_torch.core.warehouse`) on the cases of
tests/test_warehouse.py, plus what a mutable tensor and a bf16 leaf add."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import warehouse as jwarehouse
from repro_torch.core.warehouse import CredentialError, DataWarehouse, Pointer


def tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}


def test_memory_roundtrip():
    wh = DataWarehouse(device="cpu")
    ptr = wh.put(tree())
    out = wh.get(ptr.uid)
    torch.testing.assert_close(out["a"], tree()["a"], rtol=0, atol=0)


def test_disk_roundtrip(tmp_path):
    wh = DataWarehouse(root=tmp_path, device="cpu")
    ptr = wh.put(tree(), storage="disk")
    out = wh.get(ptr.uid)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.ones(4))
    assert (tmp_path / f"{ptr.uid}.npz").exists()


def test_credential_single_use():
    wh = DataWarehouse(device="cpu")
    ptr = wh.put(tree())
    tok = wh.issue_credential(ptr.uid)
    wh.fetch(tok)
    with pytest.raises(CredentialError):
        wh.fetch(tok)  # second use must fail (paper's one-time FTP login)


def test_credential_for_missing_uid():
    wh = DataWarehouse(device="cpu")
    with pytest.raises(KeyError):
        wh.issue_credential("nope")


def test_delete(tmp_path):
    wh = DataWarehouse(root=tmp_path, device="cpu")
    ptr = wh.put(tree(), storage="disk")
    wh.delete(ptr.uid)
    assert not wh.exists(ptr.uid)
    with pytest.raises(KeyError):
        wh.get(ptr.uid)


def test_pointer_identity():
    p = Pointer("10.0.0.1:9000", "abc")
    assert p.address == "10.0.0.1:9000" and p.uid == "abc"


def test_put_is_a_snapshot():
    """A JAX array cannot change after `put`; a tensor can, so the memory
    store keeps a copy: an in-place write to the source after `put` does
    not reach what `get` returns."""
    wh = DataWarehouse(device="cpu")
    src = tree()
    ptr = wh.put(src)
    src["a"].add_(100.0)
    src["b"]["c"].zero_()
    out = wh.get(ptr.uid)
    torch.testing.assert_close(out["a"], tree()["a"], rtol=0, atol=0)
    torch.testing.assert_close(out["b"]["c"], torch.ones(4), rtol=0, atol=0)


def test_get_is_a_snapshot():
    """Nor does an in-place write to what `get` or `fetch` returned (local
    training on fetched params, say) reach the stored model."""
    wh = DataWarehouse(device="cpu")
    ptr = wh.put(tree())
    got = wh.get(ptr.uid)
    got["a"].mul_(-1.0)
    fetched = wh.fetch(wh.issue_credential(ptr.uid))
    fetched["b"]["c"].add_(5.0)
    out = wh.get(ptr.uid)
    torch.testing.assert_close(out["a"], tree()["a"], rtol=0, atol=0)
    torch.testing.assert_close(out["b"]["c"], torch.ones(4), rtol=0, atol=0)


def test_bf16_disk_roundtrip_keeps_dtype(tmp_path):
    """npz has no bf16: the leaf crosses the disk as fp32 and comes back as
    bf16, its values exact."""
    wh = DataWarehouse(root=tmp_path, device="cpu")
    t = {"w": (torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
               .to(torch.bfloat16)), "n": torch.arange(4, dtype=torch.int32)}
    out = wh.get(wh.put(t, storage="disk").uid)
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int32
    torch.testing.assert_close(out["w"], t["w"], rtol=0, atol=0)
    torch.testing.assert_close(out["n"], t["n"], rtol=0, atol=0)


def test_disk_file_reads_in_the_reference(tmp_path):
    """The disk store's file is the reference's layout: its leaves, in
    order, are the arrays the JAX warehouse writes for the same tree."""
    twh = DataWarehouse(root=tmp_path / "t", device="cpu")
    jwh = jwarehouse.DataWarehouse(root=tmp_path / "j")
    jtree = {"a": jnp.arange(6.0).reshape(2, 3), "b": {"c": jnp.ones(4)}}
    tp = twh.put(tree(), storage="disk", uid="x")
    jp = jwh.put(jtree, storage="disk", uid="x")
    with np.load(tmp_path / "t" / f"{tp.uid}.npz") as zt, \
            np.load(tmp_path / "j" / f"{jp.uid}.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k])
