"""Data warehouse (paper SSIII-B.1), port of `repro.core.warehouse`:
pointer-addressed storage for model weights with one-time fetch
credentials.

The paper separates the CONTROL channel (small messages) from the BULK
channel (FTP side-channel for weights, fetched with one-time credentials).
Here: storage backends are RAM or disk (.npz); the credential dance is kept
because it is the paper's access-control mechanism and doubles as a
checkpoint-integrity layer (a credential is valid once, so a crashed fetch
can never double-apply a stale model).

Torch tensors are mutable where JAX arrays are not, so the memory store
copies on both sides: `put` stores a clone and `get` (so `fetch`) returns
one, and no caller's in-place write, to the tree it put or to a tree it
got, reaches what a later `get` returns.  The disk store writes the
leaves in `repro_torch.tree.leaves` order (the reference's), bf16 as fp32
(`checkpoint.manager.to_numpy`), and casts them back on `get`.
"""
from __future__ import annotations

import dataclasses
import os
import secrets
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import to_numpy
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class Pointer:
    """Uniquely identifies a model on a (possibly remote) warehouse."""
    address: str          # warehouse network address ("local" in-process)
    uid: str              # unique ID within that warehouse


class CredentialError(KeyError):
    pass


class DataWarehouse:
    """getter/setter store for parameter trees keyed by unique IDs
    (SSIII-B.1); `get` returns tensors on `device`."""

    def __init__(self, root: Optional[str] = None, address: str = "local",
                 device="cuda"):
        self.address = address
        self.device = resolve_device(device)
        self.root = Path(root) if root else None
        if self.root:
            self.root.mkdir(parents=True, exist_ok=True)
        self._mem: dict[str, object] = {}
        # uid -> (path, tree of leaf dtypes: the structure and the casts)
        self._disk: dict[str, tuple[Path, object]] = {}
        self._credentials: dict[str, str] = {}           # token -> uid

    # ---- setters ----
    def put(self, tree, *, storage: str = "memory", uid: Optional[str] = None
            ) -> Pointer:
        uid = uid or secrets.token_hex(8)
        if storage == "memory" or self.root is None:
            self._mem[uid] = tree_map(
                lambda x: x.detach().to(self.device, copy=True), tree)
        elif storage == "disk":
            path = self.root / f"{uid}.npz"
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, **{f"a{i}": to_numpy(l) for i, l in
                             enumerate(leaves(tree))})
            os.replace(tmp, path)  # atomic publish
            self._disk[uid] = (path, tree_map(lambda x: x.dtype, tree))
        else:
            raise ValueError(f"unknown storage '{storage}'")
        return Pointer(self.address, uid)

    # ---- getters ----
    def get(self, uid: str):
        if uid in self._mem:
            return tree_map(torch.clone, self._mem[uid])
        if uid in self._disk:
            path, dtypes = self._disk[uid]
            with np.load(path) as z:
                arrays = [z[f"a{i}"] for i in range(len(z.files))]
            flat = [torch.from_numpy(a).to(self.device, dt) for a, dt in
                    zip(arrays, leaves(dtypes))]
            return unflatten_like(dtypes, flat)
        raise KeyError(uid)

    def exists(self, uid: str) -> bool:
        return uid in self._mem or uid in self._disk

    def delete(self, uid: str):
        self._mem.pop(uid, None)
        entry = self._disk.pop(uid, None)
        if entry:
            entry[0].unlink(missing_ok=True)

    # ---- one-time credential dance (the FTP side-channel analogue) ----
    def issue_credential(self, uid: str) -> str:
        if not self.exists(uid):
            raise KeyError(uid)
        token = secrets.token_hex(16)
        self._credentials[token] = uid
        return token

    def fetch(self, token: str):
        uid = self._credentials.pop(token, None)
        if uid is None:
            raise CredentialError("invalid or already-used credential")
        return self.get(uid)
