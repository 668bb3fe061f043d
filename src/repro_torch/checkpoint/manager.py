"""Fault-tolerance substrate, port of `repro.checkpoint.manager`: atomic,
versioned checkpoints.

  * atomic publish: write .tmp then os.replace -- a crash mid-save can never
    corrupt the latest checkpoint;
  * manifest.json records step/round/FL-policy state/extra metadata;
  * rotation keeps the newest K checkpoints;
  * restore puts every tensor on `device` (the port runs on one card; the
    reference's re-sharding onto another mesh has no counterpart yet).

The on-disk format is the reference's: `step_%010d/` directories holding
`manifest.json`, `params.npz` and `opt_state.npz`, leaves under keys
a0, a1, ... in `repro_torch.tree.leaves` order (jax's sorted-key order for
dict trees), dtypes numpy lacks (bf16, fp8) stored as fp32.  Either package
restores the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten_like

_UPCAST = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def to_numpy(x) -> np.ndarray:
    """A leaf as npz stores it: tensors numpy has no dtype for go as fp32
    (the restore path casts back to the template's dtype)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in _UPCAST:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _like(arr: np.ndarray, like, device):
    """`arr` in the template leaf's dtype: a tensor on `device` (default:
    the template's) for a tensor template, else a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(
            like.device if device is None else device, like.dtype)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def save_pytree(tree, path: Path):
    """Atomic .npz save of a tree of tensors / arrays."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:  # file handle: savez won't append a suffix
        np.savez(f, **{f"a{i}": to_numpy(l)
                       for i, l in enumerate(leaves(tree))})
    os.replace(tmp, path)


def load_pytree(path: Path, like_tree, *, device=None):
    """Restore into the structure and leaf dtypes of `like_tree`."""
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("a")])
        arrays = [z[f"a{i}"] for i in range(n)]
    likes = leaves(like_tree)
    if len(arrays) != len(likes):
        raise ValueError(f"{path}: {len(arrays)} leaves, the template has "
                         f"{len(likes)}")
    return unflatten_like(like_tree, [_like(a, l, device)
                                      for a, l in zip(arrays, likes)])


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._recover()

    # ---- save ----
    def save(self, step: int, *, params, opt_state=None, extra: Optional[dict]
             = None):
        ckpt = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        old = self.dir / f".old_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        save_pytree(params, tmp / "params.npz")
        if opt_state is not None:
            save_pytree(opt_state, tmp / "opt_state.npz")
        manifest = {"step": int(step), "time": time.time(),
                    "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        # Overwrite without a crash window: rename the published dir ASIDE
        # (atomic), publish the new one (atomic), only then delete the old.
        # A crash at any point leaves a loadable copy of this step on disk
        # (either step_X or .old_step_X; _recover() renames the latter
        # back).
        if old.exists():
            shutil.rmtree(old)
        if ckpt.exists():
            os.replace(ckpt, old)
        os.replace(tmp, ckpt)  # atomic publish
        if old.exists():
            shutil.rmtree(old)
        self._rotate()
        return ckpt

    def _recover(self):
        """Finish an interrupted overwrite: a .old_step_X with no published
        step_X means the crash hit between un-publish and re-publish --
        restore the old copy (it is a complete, previously published
        checkpoint).  A .old with a published sibling is garbage from a
        crash after publish; delete it, along with stale .tmp dirs."""
        for p in self.dir.glob(".old_step_*"):
            step = p.name.split("_")[-1]
            published = self.dir / f"step_{step}"
            if published.exists():
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.replace(p, published)
        for p in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(p, ignore_errors=True)

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---- discovery ----
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def path_for(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- restore ----
    def restore(self, *, params_like, opt_state_like=None, step: Optional[int]
                = None, device=None):
        """Returns (step, params, opt_state, extra), leaves in the
        templates' dtypes, tensors on `device` (default: each template
        leaf's device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        ckpt = self.path_for(step)
        manifest = json.loads((ckpt / "manifest.json").read_text())
        params = load_pytree(ckpt / "params.npz", params_like, device=device)
        opt_state = None
        if opt_state_like is not None and (ckpt / "opt_state.npz").exists():
            opt_state = load_pytree(ckpt / "opt_state.npz", opt_state_like,
                                    device=device)
        return step, params, opt_state, manifest.get("extra", {})
