"""The compressed cross-island weight exchange on the PyTorch port.

The workload of the JAX package's benchmarks/fl_exchange.py, at its own
sizes: a seeded mixed-shape, mixed-dtype tree of 656,643 params per island
(embed 512x256, w1 256x1024, w2 1024x256 and bias 1027 in fp32, ln 256 in
bf16), stacked over P = 2, 4, 8 islands with small per-island deltas from a
shared base, exchanged through `launch.steps.make_fl_aggregate` in the
modes f32, q8, topk and q8_topk -- flat, then edge -> fog -> cloud through
2 fog cells.  Per cell it prints the wire bytes
(`core.compression.compressed_bytes`), the reduction against f32 and the
time per exchange (CUDA events on the card), and it checks the benchmark's
invariants: q8 at least 3.5x smaller than f32, q8_topk smaller than q8,
and the kernel exchange within 1e-2 of the plain one.  On the card every
q8 exchange hop quantises and dequantises all its leaves in one grouped
launch of each quant8 kernel.

`island_rounds` runs the paper's own model the same way: islands of
flight-cnn-mnist train a local epoch each round (`cohort_train`) and
exchange int8 deltas through the fog tier.

  PYTHONPATH=src python -m repro_torch.examples.fl_exchange [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.configs import get_config
from repro_torch.core import compression, federated, hierarchy
from repro_torch.core.client import LocalTrainer
from repro_torch.data.partition import partition_by_batches
from repro_torch.data.synthetic import make_classification_set
from repro_torch.launch.steps import make_fl_aggregate
from repro_torch.models import build_model
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves, tree_map

MODES = ("f32", "q8", "topk", "q8_topk")
ISLANDS = (2, 4, 8)
K_FRAC = 0.05
ROUNDS = 10
PARITY_BOUND = 1e-2

# wire accounting per mode, as the benchmark counts it: q8 rides the
# rowwise layout (the exchange's actual form); the topk modes are counted
# in wire form (int32 idx + fp32 val, resp. idx + block-padded int8)
BYTES_MODE = {"f32": "none", "q8": "q8_rowwise", "topk": "topk",
              "q8_topk": "q8_topk"}


def make_tree(P: int, seed: int = 0, device="cpu"):
    """-> (stacked, base): the benchmark's mixed tree, base tiled over P
    islands and stacked = base + N(0, 0.01) per island, drawn from numpy
    in the reference's order (so both packages get the same values)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    one = {"embed": f32(rng.normal(size=(512, 256))),
           "w1": f32(rng.normal(size=(256, 1024))),
           "w2": f32(rng.normal(size=(1024, 256))),
           "bias": f32(rng.normal(size=(1027,))),
           "ln": torch.from_numpy(rng.normal(size=(256,))).to(torch.bfloat16)}
    base = federated.stack_islands(tree_map(lambda x: x.to(device), one), P)
    stacked = tree_map(
        lambda x: (x.float() + f32(rng.normal(size=tuple(x.shape)) * 0.01)
                   .to(device)).to(x.dtype), base)
    return stacked, base


def wire_bytes(tree, mode: str) -> int:
    return compression.compressed_bytes(tree, mode=BYTES_MODE[mode],
                                        k_frac=K_FRAC)


def exchange_fn(P: int, mode: str, *, fog_cells: int = 1, impl: str = "auto",
                device="cpu"):
    """-> fn(stacked, base): one exchange of P islands with uniform
    weights, flat (`make_fl_aggregate`) or through `fog_cells` fog cells
    (`hierarchy.hierarchical_sync_aggregate`, cell = island % fog_cells)."""
    w = np.full(P, 1.0 / P)
    compress = "none" if mode == "f32" else mode
    if fog_cells > 1:
        cell_of = np.arange(P) % fog_cells
        return lambda stacked, base: hierarchy.hierarchical_sync_aggregate(
            stacked, w, cell_of, compress=compress,
            base_params=None if compress == "none" else base,
            k_frac=K_FRAC, impl=impl)
    M = torch.as_tensor(federated.selection_mixing(w, np.ones(P)),
                        dtype=torch.float32, device=device)
    agg = make_fl_aggregate(compress=False if mode == "f32" else mode,
                            k_frac=K_FRAC, impl=impl)
    if mode == "f32":
        return lambda stacked, base: agg(stacked, M)
    return lambda stacked, base: agg(stacked, base, M)


def time_ms(fn, device: torch.device, rounds: int) -> float:
    """ms per call: CUDA events over `rounds` calls on the card (the
    device's timeline, host gaps included), the host clock on the CPU."""
    fn()
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / rounds
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    return (time.perf_counter() - t0) * 1e3 / rounds


def max_abs_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def run(device="cuda", *, islands=ISLANDS, modes=MODES, fog_cells: int = 1,
        impl: str = "auto", rounds: int = ROUNDS, seed: int = 0):
    """-> (cells, outputs): per `P{P}_{mode}` cell the benchmark's record
    (islands, mode, wire_mb_per_round, reduction_vs_f32, exchange_ms) and
    the exchange's output tree."""
    dev = resolve_device(device)
    cells, outputs = {}, {}
    for P in islands:
        stacked, base = make_tree(P, seed, dev)
        f32_bytes = wire_bytes(stacked, "f32")
        for mode in modes:
            fn = exchange_fn(P, mode, fog_cells=fog_cells, impl=impl,
                             device=dev)
            outputs[f"P{P}_{mode}"] = fn(stacked, base)
            ms = time_ms(lambda: fn(stacked, base), dev, rounds)
            wb = wire_bytes(stacked, mode)
            cells[f"P{P}_{mode}"] = {
                "islands": P, "mode": mode,
                "wire_mb_per_round": round(wb / 1e6, 4),
                "reduction_vs_f32": round(f32_bytes / wb, 2),
                "exchange_ms": ms,
            }
    return cells, outputs


def measure_parity(device="cuda", *, P: int = 4, fog_cells: int = 1) -> dict:
    """Kernel (impl="auto") vs plain (impl="ref") exchange on the mixed
    tree at seed 7, as the benchmark measures it (on the CPU both are the
    plain version)."""
    dev = resolve_device(device)
    stacked, base = make_tree(P, seed=7, device=dev)
    out = {}
    for mode in ("q8", "q8_topk"):
        got, want = (exchange_fn(P, mode, fog_cells=fog_cells, impl=impl,
                                 device=dev)(stacked, base)
                     for impl in ("auto", "ref"))
        out[f"{mode}_kernel_vs_ref_max_abs"] = max_abs_diff(got, want)
    return out


def check_invariants(cells: dict, parity: dict,
                     islands=ISLANDS) -> list[str]:
    bad = []
    for P in islands:
        q8, qtk = cells[f"P{P}_q8"], cells[f"P{P}_q8_topk"]
        if q8["reduction_vs_f32"] < 3.5:
            bad.append(f"P{P}: q8 reduction {q8['reduction_vs_f32']} < 3.5x")
        if not qtk["wire_mb_per_round"] < q8["wire_mb_per_round"]:
            bad.append(f"P{P}: q8_topk bytes not < q8 bytes")
    for k, v in parity.items():
        if not v <= PARITY_BOUND:
            bad.append(f"parity {k} = {v} > {PARITY_BOUND}")
    return bad


def island_rounds(device="cuda", *, islands: int = 4, fog_cells: int = 2,
                  rounds: int = 3, batches: int = 2, batch_size: int = 64,
                  compress: str = "q8", impl: str = "auto", seed: int = 0):
    """The paper's model across islands: `islands` copies of
    flight-cnn-mnist at full width, each with an equal shard of `batches`
    batches of synMNIST, train one local epoch per round as one cohort
    (`federated.cohort_train`) and exchange their deltas from the shared
    last-sync model through `hierarchical_sync_aggregate(compress=...)`
    with `fog_cells` fog cells.  -> (final params, accuracy per round on
    1,024 test images)."""
    dev = resolve_device(device)
    model = build_model(get_config("flight-cnn-mnist"))
    trainer = LocalTrainer(model, lr=0.05, batch_size=batch_size)
    images, labels = make_classification_set(
        "synmnist", islands * batches * batch_size, seed=seed)
    shards = partition_by_batches(images, labels, [batches] * islands,
                                  batch_size=batch_size, seed=seed)
    test_i, test_l = make_classification_set("synmnist", 1024, seed=9)
    test_i, test_l = torch.as_tensor(test_i, device=dev), \
        torch.as_tensor(test_l, device=dev)
    weights = [s[0].shape[0] for s in shards]
    cell_of = np.arange(islands) % fog_cells
    params = model.init(threefry.key(seed), dev)
    key = threefry.key(seed + 1)
    accs = []
    for _ in range(rounds):
        key, *member_keys = threefry.split(key, islands + 1)
        stacked = federated.cohort_train(trainer, params, shards,
                                         member_keys, epochs=1)
        mixed = hierarchy.hierarchical_sync_aggregate(
            stacked, weights, cell_of, compress=compress,
            base_params=federated.stack_islands(params, islands), impl=impl)
        params = federated.island_slice(mixed, 0)
        accs.append(trainer.evaluate(params, test_i, test_l))
    return params, accs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "host"
    bad = []
    for fog_cells in (1, 2):
        tier = "flat" if fog_cells == 1 else f"{fog_cells} fog cells"
        cells, _ = run(dev, fog_cells=fog_cells)
        for name, c in cells.items():
            f32_mb = cells[f"P{c['islands']}_f32"]["wire_mb_per_round"]
            print(f"[fl_exchange] {tier} P={c['islands']} {c['mode']:8s} "
                  f"{c['wire_mb_per_round']:8.4f} MB/round "
                  f"({c['reduction_vs_f32']:5.2f}x vs f32 {f32_mb:.4f} MB) "
                  f"{c['exchange_ms']:9.4f} ms/exchange ({where})",
                  flush=True)
        parity = measure_parity(dev, fog_cells=fog_cells)
        for k, v in parity.items():
            print(f"[fl_exchange] {tier} parity {k} = {v:.3e}")
        bad += [f"{tier}: {b}" for b in check_invariants(cells, parity)]
    for b in bad:
        print(f"[fl_exchange] INVARIANT VIOLATED: {b}")
    params_per_island = sum(math.prod(x.shape[1:]) for x in
                            leaves(make_tree(1)[0]))
    print(f"[fl_exchange] {params_per_island} params per island")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
