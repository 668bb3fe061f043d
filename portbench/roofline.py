"""The yardstick's arithmetic: the card's published peaks and the
operations and bytes a step or a kernel needs, computed from shapes.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def quant8_bytes(elements: int, rows: int) -> tuple[int, int]:
    """(quantise, dequantise) bytes of a float32 tensor round trip with
    one float32 scale a row: float32 in, int8 and scales out; and back."""
    q = 4 * elements + elements + 4 * rows
    dq = elements + 4 * rows + 4 * elements
    return q, dq


def train_flops_per_token(n_active: int, n_layers: int, attn_width: int,
                          seq: int) -> float:
    """6 N (forward and backward of the matrix products a token passes
    through, N the active parameters without the input embedding table)
    + 12 L (H D) T (the attention products over the query heads' width
    H D); remat's recompute is not counted.  A family's layout
    (`layouts/<family>.train_flops_per_token`) says what N and H D are
    for its blocks."""
    return 6.0 * n_active + 12.0 * n_layers * attn_width * seq

