"""FL worker: local training on a private data shard (paper SSIII-C.3),
port of `repro.core.client`.

The worker never shares raw data, only the resulting weights -- the FL
invariant.  The reference draws each epoch's batch order inside its jitted
trainer from a `jax.random` key; here the batch order is an argument, an
(epochs, >= nb*bs) index tensor, and `draw_orders(key, n, epochs)` gives
the one the reference draws from `key`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import threefry
from repro_torch.core.aggregation import tree_finite
from repro_torch.tree import leaves, tree_map


def softmax_xent(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def accuracy(logits, labels):
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def draw_orders(key: np.ndarray, n: int, epochs: int) -> torch.Tensor:
    """(epochs, n) int64: the reference trainer's batch orders for a
    Threefry `key` -- `split(key, epochs)`, then one permutation of
    range(n) per epoch key.  Drawn on the host, so one key gives the same
    orders on every device."""
    orders = [threefry.permutation(k, n) for k in threefry.split(key, epochs)]
    return torch.from_numpy(np.array(orders, np.int64).reshape(epochs, n))


@dataclasses.dataclass
class LocalTrainer:
    """SGD-with-momentum local trainer for classifier models."""
    model: object                 # repro_torch.models.Model
    lr: float = 0.05
    momentum: float = 0.9
    batch_size: int = 64

    def geometry(self, n: int) -> tuple[int, int]:
        """(batch size, batches per epoch); the tail after nb*bs is dropped."""
        bs = min(self.batch_size, n)
        return bs, max(n // bs, 1)

    def _loss(self, params, images, labels):
        logits, aux = self.model.apply(params, {"images": images},
                                       mode="train")
        return softmax_xent(logits, labels) + 0.01 * aux

    def _step(self, params, mom, images, labels):
        g = grad(self._loss)(params, images, labels)
        mom = tree_map(lambda m, gg: self.momentum * m + gg, mom, g)
        params = tree_map(lambda p, m: p - self.lr * m, params, mom)
        return params, mom

    def _orders(self, order, n, epochs, device):
        bs, nb = self.geometry(n)
        order = torch.as_tensor(order)
        if order.shape[-2] != epochs or order.shape[-1] < nb * bs:
            raise ValueError(f"batch order {tuple(order.shape)}: need "
                             f"({epochs}, >= {nb * bs}) per member")
        return order[..., : nb * bs].to(device, torch.int64), bs, nb

    def train(self, params, images, labels, epochs: int, *, order):
        """`epochs` passes of minibatch SGD with momentum (buffer zeroed on
        each call) over `images` in the batch order `order`."""
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels).long()
        order, bs, nb = self._orders(order, images.shape[0], int(epochs),
                                     images.device)
        mom = tree_map(torch.zeros_like, params)
        for e in range(int(epochs)):
            for idx in order[e].reshape(nb, bs):
                params, mom = self._step(params, mom, images[idx],
                                         labels[idx])
        return params

    def train_checked(self, params, images, labels, epochs: int, *, order):
        """`train` with the non-finite guard: a diverged local step (any
        NaN/Inf in the result) is SKIPPED -- the input params come back
        unchanged with ok=False so the caller can report the divergence
        instead of shipping poison to the aggregator."""
        new = self.train(params, images, labels, epochs, order=order)
        if tree_finite(new):
            return new, True
        return params, False

    def train_cohort(self, params, images, labels, orders, epochs: int):
        """Batched local training: one vmapped step over the cohort axis.

        images: (C, S, ...), labels: (C, S), orders: (C, epochs, >= nb*bs)
        per-member batch orders.  Returns params stacked over the cohort
        axis (C, ...); member i equals `train(params, images[i], labels[i],
        order=orders[i])` up to batched-convolution reduction order."""
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels).long()
        C, n = images.shape[:2]
        orders, bs, nb = self._orders(orders, n, int(epochs), images.device)
        stacked = tree_map(
            lambda p: p.unsqueeze(0).expand(C, *p.shape).contiguous(), params)
        mom = tree_map(torch.zeros_like, stacked)
        member = torch.arange(C, device=images.device)[:, None]
        step = vmap(self._step)
        for e in range(int(epochs)):
            for b in range(nb):
                idx = orders[:, e, b * bs:(b + 1) * bs]            # (C, bs)
                stacked, mom = step(stacked, mom, images[member, idx],
                                    labels[member, idx])
        return stacked

    def train_cohort_checked(self, params, images, labels, orders,
                             epochs: int):
        """`train_cohort` with the per-member non-finite guard: diverged
        members are replaced by the unchanged input params and flagged
        False in the returned (C,) ok vector."""
        stacked = self.train_cohort(params, images, labels, orders, epochs)
        C = leaves(stacked)[0].shape[0]
        oks = torch.stack([torch.isfinite(l.float()).reshape(C, -1).all(1)
                           for l in leaves(stacked)]).all(0)
        oks = oks.cpu().numpy()
        if not oks.all():
            bad = torch.as_tensor(~oks, device=leaves(stacked)[0].device)
            stacked = tree_map(
                lambda s, p: torch.where(
                    bad.reshape((-1,) + (1,) * p.dim()), p[None], s),
                stacked, params)
        return stacked, oks

    @torch.no_grad()
    def evaluate(self, params, images, labels) -> float:
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels).to(images.device)
        logits, _ = self.model.apply(params, {"images": images}, mode="train")
        return float(accuracy(logits, labels))


@dataclasses.dataclass
class SimWorker:
    """One simulated worker: data shard + trainer + ground-truth profile."""
    wid: int
    images: np.ndarray
    labels: np.ndarray
    trainer: LocalTrainer
    profile: object               # WorkerProfile

    base_version: int = -1        # server version the local model is based on
    diverged: bool = False        # last local step hit the non-finite guard

    def local_train(self, params, order, epochs: int):
        """`order`: this dispatch's (epochs, >= nb*bs) batch order."""
        if self.images.shape[0] == 0:
            return params
        dev = leaves(params)[0].device
        new, ok = self.trainer.train_checked(
            params, torch.as_tensor(self.images, device=dev),
            torch.as_tensor(self.labels, device=dev), epochs, order=order)
        self.diverged = not ok
        return new
