"""quant8's single-tensor calls at the shapes where one launch a leaf or a
row too wide to hold in registers decides the time.

For each shape, `quantize_rows_cuda` and `dequantize_rows_cuda` (output in
the input's dtype) are held bit for bit against the plain version and
timed in CUDA-graph time, warm (inputs in L2) and cold (L2 flushed by a
256 MB read first, less the flush alone): the sweep's rows too wide to
hold (151,936 wide at 1, 27 and 441 rows, the odd 50,257, 300 rows of
8,200) in fp32 and bf16, then the five leaves of one P = 8 exchange as
five single-leaf launches, and as one grouped launch where the tree has
`quantize_grouped_cuda`.  It uses only those calls and the plain version,
so it can time an older tree of the port too:

  PYTHONPATH=src python -m repro_torch.examples.quant8_shapes
  PYTHONPATH=<older tree>/src python src/repro_torch/examples/quant8_shapes.py
"""
from __future__ import annotations

import subprocess

import torch

import repro_torch
from repro_torch.examples import fl_exchange
from repro_torch.kernels.quant8 import kernel as q8
from repro_torch.kernels.quant8.ref import dequantize_rows_ref, quantize_rows_ref
from repro_torch.runtime import resolve_device

WIDE = [(1, 151_936), (27, 151_936), (441, 151_936), (3, 50_257),
        (300, 8200)]
EXCHANGE_P = 8
FLUSH_BYTES = 256 << 20


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rows(R: int, C: int, dtype, seed: int) -> torch.Tensor:
    """Normal rows over four decades of scale; rows 0-2 hold a NaN, +inf,
    -inf."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, C, generator=g, device="cuda")
    x *= 10.0 ** (torch.rand(R, 1, generator=g, device="cuda") * 4 - 2)
    for r, (c, v) in enumerate([(C // 2, float("nan")), (C - 1, float("inf")),
                                (0, float("-inf"))][:R]):
        x[r, c] = v
    return x.to(dtype)


def timed(label: str, xs: list[torch.Tensor], flush) -> None:
    """Both kernels over xs, one single-tensor call a leaf."""
    qss = [q8.quantize_rows_cuda(x) for x in xs]
    for x, (q, s) in zip(xs, qss):
        qr, sr = quantize_rows_ref(x)
        out = q8.dequantize_rows_cuda(q, s, x.dtype)
        torch.cuda.synchronize()
        assert torch.equal(q, qr), f"{label}: q differs from ref.py"
        torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(out, dequantize_rows_ref(q, s, x.dtype),
                                   rtol=0, atol=0, equal_nan=True)
    quant = lambda: [q8.quantize_rows_cuda(x) for x in xs]
    deq = lambda: [q8.dequantize_rows_cuda(q, s, x.dtype)
                   for x, (q, s) in zip(xs, qss)]
    parts = []
    for name, fn in (("quantize", quant), ("dequantize", deq)):
        warm = graph_ms(fn, 20)
        cold = graph_ms(lambda: (flush(), fn()), 10) - graph_ms(flush, 10)
        parts.append(f"{name} {cold * 1e3:.3f} us cold, {warm * 1e3:.3f} "
                     "us warm")
    print(f"{label}: {' | '.join(parts)}; bit-equal", flush=True)


def main():
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"tree: {repro_torch.__file__}")
    big = torch.empty(FLUSH_BYTES // 4, device="cuda").normal_()
    total = torch.empty((), device="cuda")
    flush = lambda: torch.sum(big, dim=0, out=total)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for R, C in WIDE:
            timed(f"{R} x {C} {name}", [rows(R, C, dtype, R * C)], flush)
    stacked, base = fl_exchange.make_tree(EXCHANGE_P, device="cuda")
    xs = []
    for leaf in sorted(stacked):
        delta = stacked[leaf].float() - base[leaf].float()
        xs.append(delta.reshape(-1, delta.shape[-1]).contiguous())
    timed(f"P={EXCHANGE_P} exchange, {len(xs)} single-leaf launches "
          f"{[tuple(x.shape) for x in xs]} float32", xs, flush)
    if hasattr(q8, "quantize_grouped_cuda"):
        qss = q8.quantize_grouped_cuda(xs)
        qs, ss = [q for q, _ in qss], [s for _, s in qss]
        parts = []
        for name, fn in (
                ("quantize", lambda: q8.quantize_grouped_cuda(xs)),
                ("dequantize",
                 lambda: q8.dequantize_grouped_cuda(qs, ss, torch.float32))):
            warm = graph_ms(fn, 20)
            cold = graph_ms(lambda: (flush(), fn()), 10) - graph_ms(flush, 10)
            parts.append(f"{name} {cold * 1e3:.3f} us cold, "
                         f"{warm * 1e3:.3f} us warm")
        print(f"P={EXCHANGE_P} exchange, one grouped launch: "
              f"{' | '.join(parts)}", flush=True)


if __name__ == "__main__":
    main()
