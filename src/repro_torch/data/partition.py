"""Federated data partitioner -- the paper's Tables III/IV verbatim, plus
general batch-count and Dirichlet non-IID partitioners.

The paper allocates BATCHES of data per worker; configs 1/4 put everything
on W1 (the sequential baseline), 2/5 are even, 3/6 uneven.  Data is split
WITHOUT overlap (paper: 'all workers have ... distinct training data').
"""
from __future__ import annotations

import numpy as np

# --- Table III: 10 workers.  worker index -> batches, per config ----------
# columns: W1, W2/W3, W4, W5/W6, W7, W8/W9/W10
_T3 = {
    1: ("synmnist", [10, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
    2: ("synmnist", [1] * 10),
    3: ("synmnist", [1, 0, 0, 3, 0, 0, 0, 2, 2, 2]),
    4: ("syncifar", [100, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
    5: ("syncifar", [10] * 10),
    6: ("syncifar", [10, 0, 0, 30, 0, 0, 0, 20, 20, 20]),
}

# --- Table IV: 30 workers --------------------------------------------------
# columns: W1, W2-W10, W11, W12-W20, W21, W22-W30
def _t4_row(w1, w2_10, w11, w12_20, w21, w22_30):
    return [w1] + [w2_10] * 9 + [w11] + [w12_20] * 9 + [w21] + [w22_30] * 9

_T4 = {
    1: ("synmnist", _t4_row(30, 0, 0, 0, 0, 0)),
    2: ("synmnist", [1] * 30),
    3: ("synmnist", _t4_row(4, 0, 8, 0, 0, 2)),
    4: ("syncifar", _t4_row(300, 0, 0, 0, 0, 0)),
    5: ("syncifar", [10] * 30),
    6: ("syncifar", _t4_row(40, 0, 80, 0, 0, 20)),
}


def paper_table3(config: int):
    """-> (dataset_kind, batches_per_worker list, n_workers=10)."""
    kind, rows = _T3[config]
    return kind, list(rows)


def paper_table4(config: int):
    kind, rows = _T4[config]
    return kind, list(rows)


def partition_by_batches(images, labels, batches_per_worker, *,
                         batch_size: int = 64, seed: int = 0):
    """Split (images, labels) into disjoint worker shards of
    `batches_per_worker[i] * batch_size` samples each."""
    n_needed = sum(batches_per_worker) * batch_size
    assert n_needed <= len(images), (n_needed, len(images))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(images))[:n_needed]
    shards, off = [], 0
    for nb in batches_per_worker:
        take = nb * batch_size
        idx = order[off: off + take]
        shards.append((images[idx], labels[idx]))
        off += take
    return shards


def dirichlet_partition(images, labels, n_workers: int, *, alpha: float = 0.5,
                        seed: int = 0):
    """Label-skewed non-IID split (beyond-paper; standard FL benchmark)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    worker_idx = [[] for _ in range(n_workers)]
    for idx in idx_by_class:
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_workers)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, cuts)):
            worker_idx[w].extend(part.tolist())
    return [(images[np.array(ix, int)], labels[np.array(ix, int)])
            if ix else (images[:0], labels[:0]) for ix in worker_idx]
