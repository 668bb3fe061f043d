"""The port's checkpoint manager (`repro_torch.checkpoint`) on the cases of
tests/test_checkpoint.py (the sharding case becomes `device=`), and
checkpoints written by either package restored by the other."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.tree import leaves, tree_map


def tree(v=1.0):
    return {"w": torch.full((4, 2), v, dtype=torch.bfloat16),
            "o": {"mu": torch.full((4, 2), v / 2, dtype=torch.float32)}}


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def test_save_load_roundtrip(tmp_path):
    p = tmp_path / "x.npz"
    save_pytree(tree(3.0), p)
    out = load_pytree(p, tree())
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["w"].float().numpy(), 3.0)


def test_manager_roundtrip_and_manifest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, params=tree(1.0), opt_state={"c": _i32(7)},
             extra={"round": 4, "policy_T": 3.5})
    step, params, opt, extra = mgr.restore(
        params_like=tree(), opt_state_like={"c": _i32(0)})
    assert step == 10 and extra["round"] == 4
    np.testing.assert_allclose(params["w"].float().numpy(), 1.0)
    assert int(opt["c"]) == 7 and opt["c"].dtype == torch.int32


def test_rotation_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, params=tree(float(s)))
    assert mgr.all_steps() == [3, 4]
    step, params, _, _ = mgr.restore(params_like=tree())
    assert step == 4
    np.testing.assert_allclose(params["w"].float().numpy(), 4.0)


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    for s in (1, 2):
        mgr.save(s, params=tree(float(s)))
    step, params, _, _ = mgr.restore(params_like=tree(), step=1)
    assert step == 1
    np.testing.assert_allclose(params["w"].float().numpy(), 1.0)


def test_no_partial_checkpoint_on_disk(tmp_path):
    """Atomic publish: no .tmp dirs left behind after a successful save."""
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(5, params=tree())
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_restore_to_device(tmp_path):
    """`device=` (the reference's `shardings=` on one card) places every
    restored tensor, params and optimiser state, in the template's dtype;
    without it each leaf follows its template."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, params=tree(2.0), opt_state={"m": torch.ones(3)})
    _, params, opt, _ = mgr.restore(params_like=tree(),
                                    opt_state_like={"m": torch.zeros(3)},
                                    device="cpu")
    assert {l.device.type for l in (params["w"], params["o"]["mu"],
                                    opt["m"])} == {"cpu"}
    assert params["w"].dtype == torch.bfloat16
    assert params["o"]["mu"].dtype == torch.float32
    _, params, _, _ = mgr.restore(params_like=tree())
    assert params["w"].device == tree()["w"].device


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(params_like=tree())


def test_overwrite_same_step_keeps_newest(tmp_path):
    """Re-saving a step (crash-retry of the same round) replaces it and the
    overwrite has NO crash window."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(7, params=tree(1.0))
    mgr.save(7, params=tree(2.0))
    assert mgr.all_steps() == [7]
    _, params, _, _ = mgr.restore(params_like=tree())
    np.testing.assert_allclose(params["w"].float().numpy(), 2.0)
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".old")]


def test_recover_interrupted_overwrite(tmp_path):
    """A crash BETWEEN un-publish and re-publish: a fresh manager restores
    the .old copy."""
    mgr = CheckpointManager(tmp_path, keep=3)
    ckpt = mgr.save(3, params=tree(5.0))
    os.replace(ckpt, tmp_path / ".old_step_0000000003")  # crash mid-overwrite
    assert CheckpointManager(tmp_path).all_steps() == [3]
    _, params, _, _ = CheckpointManager(tmp_path).restore(params_like=tree())
    np.testing.assert_allclose(params["w"].float().numpy(), 5.0)


def test_recover_discards_stale_leftovers(tmp_path):
    """A .old with a published sibling and stale .tmp dirs are garbage."""
    mgr = CheckpointManager(tmp_path, keep=3)
    ckpt = mgr.save(3, params=tree(9.0))
    shutil.copytree(ckpt, tmp_path / ".old_step_0000000003")
    (tmp_path / ".tmp_step_0000000004").mkdir()
    mgr2 = CheckpointManager(tmp_path)
    assert mgr2.all_steps() == [3]
    leftovers = [p.name for p in tmp_path.iterdir()
                 if p.name.startswith((".old", ".tmp"))]
    assert leftovers == []
    _, params, _, _ = mgr2.restore(params_like=tree())
    np.testing.assert_allclose(params["w"].float().numpy(), 9.0)


# -- across the two packages ---------------------------------------------

def _trees(dtype: str, seed: int = 0):
    """The same values as a JAX tree and a port tree: three leaves of
    `dtype` whose sorted-key order differs from their insertion order."""
    rng = np.random.default_rng(seed)
    vals = {"z": rng.normal(size=(3, 4)), "a": rng.normal(size=(5,)),
            "m": {"k": rng.normal(size=(2, 2, 2))}}
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jt = jax.tree.map(lambda v: jnp.asarray(v.astype(np.float32)
                                            .astype(np_dt)), vals)
    tt = tree_map(lambda v: torch.from_numpy(v.astype(np.float32))
                  .to(getattr(torch, dtype)), vals)
    return jt, tt


def _equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    jt, tt = _trees(dtype)
    jckpt.save_pytree(jt, tmp_path / "x.npz")
    out = load_pytree(tmp_path / "x.npz", tt)
    assert out["z"].dtype == tt["z"].dtype
    _equal(jt, out)
    jckpt.CheckpointManager(tmp_path / "m").save(
        3, params=jt, opt_state={"n": jnp.int32(5)}, extra={"round": 3})
    step, params, opt, extra = CheckpointManager(tmp_path / "m").restore(
        params_like=tt, opt_state_like={"n": _i32(0)})
    assert (step, extra, int(opt["n"])) == (3, {"round": 3}, 5)
    assert params["m"]["k"].dtype == tt["m"]["k"].dtype
    _equal(jt, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    jt, tt = _trees(dtype, seed=1)
    save_pytree(tt, tmp_path / "x.npz")
    _equal(jckpt.load_pytree(tmp_path / "x.npz", jt), tt)
    CheckpointManager(tmp_path / "m").save(
        4, params=tt, opt_state={"n": _i32(6)},
        extra={"round": 4})
    step, params, opt, extra = jckpt.CheckpointManager(tmp_path / "m").restore(
        params_like=jt, opt_state_like={"n": jnp.int32(0)})
    assert (step, extra, int(opt["n"])) == (4, {"round": 4}, 6)
    assert params["z"].dtype == jt["z"].dtype
    _equal(params, tt)
    manifest = json.loads((tmp_path / "m" / "step_0000000004" /
                           "manifest.json").read_text())
    assert manifest["step"] == 4
