"""The hardware model of the port: one NVIDIA H100 SXM5 80 GB, from its
data sheet, and the roofline read against it.

  bf16 dense tensor-core peak        989e12 FLOP/s
  fp32 outside the tensor cores       67e12 FLOP/s (the port runs fp32
                                      products with TF32 off)
  HBM3 bandwidth                     3.35e12 B/s
  device memory                        80e9 B
  link_bw   50e9 B/s:  the "data" and "pod" mesh axes cross nodes, one
            400 Gb/s NDR port a GPU
  nvlink_bw 450e9 B/s a direction: the "model" axis, the NVLink domain
            of one 8-GPU node (launch/mesh.py)

`Roofline` keeps the reference's three terms (`repro.dist.hlo_analysis`)
with two changes: its compute term charges each dtype's flops at that
dtype's peak, and its collective term charges each mesh axis's bytes at
that axis's bandwidth.  On a `Hardware` of one rate and one link
bandwidth it is the reference's formula.

The kernels' work formulas live here too, one a kernel: the (flops by
dtype, bytes) each hand-written kernel does on its inputs.  chip_smoke.py
reads its bound column from them (`work_bound`), and each kernel's
dispatcher reports them to an active cost walk (dist/cost.py), which
cannot see inside a kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
DEVICE_HBM_BYTES = 80e9      # H100 SXM5 80 GB
LINK_BYTES_PER_S = 50e9      # one 400 Gb/s NDR port a GPU (data, pod)
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, one direction (model)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's rates and memory, and its mesh axes' bandwidths."""
    name: str
    flops_per_s: dict            # dtype name -> peak FLOP/s
    hbm_bw: float                # B/s
    hbm_bytes: float             # device memory, B
    link_bw: float               # B/s, the "data" / "pod" axes
    nvlink_bw: float             # B/s, the "model" axis

    def rate(self, dtype: str) -> float:
        """Peak FLOP/s for a dtype name ("bfloat16", "float32", ...);
        a dtype the table lacks is charged at the fp32 rate."""
        return self.flops_per_s.get(dtype, self.flops_per_s["float32"])

    def axis_bw(self, axis: str) -> float:
        return self.nvlink_bw if axis == "model" else self.link_bw


H100 = Hardware(
    "NVIDIA H100 SXM5 80GB",
    {"bfloat16": BF16_FLOPS_PER_S, "float16": BF16_FLOPS_PER_S,
     "float32": FP32_FLOPS_PER_S},
    HBM_BYTES_PER_S, DEVICE_HBM_BYTES, LINK_BYTES_PER_S, NVLINK_BYTES_PER_S)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term per-device roofline on `hw`: each dtype's flops at that
    dtype's peak, the HBM bytes at its bandwidth, each mesh axis's
    collective bytes at that axis's bandwidth."""
    flops_by_dtype: dict                      # dtype -> flops
    hbm_bytes: float
    collective_by_axis: dict = dataclasses.field(default_factory=dict)
    hw: Hardware = H100

    @classmethod
    def of(cls, cost: dict, collective_by_axis: dict | None = None,
           hw: Hardware = H100) -> "Roofline":
        """From a cost walk's totals (dist/cost.analyze) on `hw`."""
        return cls(dict(cost["flops_by_dtype"]), float(cost["hbm_bytes"]),
                   dict(collective_by_axis or {}), hw)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_by_axis.values()))

    @property
    def t_compute_s(self) -> float:
        return sum(f / self.hw.rate(dt)
                   for dt, f in self.flops_by_dtype.items())

    @property
    def t_memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective_s(self) -> float:
        return sum(b / self.hw.axis_bw(ax)
                   for ax, b in self.collective_by_axis.items())

    @property
    def bound_s(self) -> float:
        return max(self.t_compute_s, self.t_memory_s, self.t_collective_s)

    @property
    def dominant(self) -> str:
        terms = (("compute", self.t_compute_s), ("memory", self.t_memory_s),
                 ("collective", self.t_collective_s))
        return max(terms, key=lambda kv: kv[1])[0]

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1e-9)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute_s,
            "t_memory_s": self.t_memory_s,
            "t_collective_s": self.t_collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "arithmetic_intensity": self.arithmetic_intensity,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "collective_by_axis": dict(self.collective_by_axis),
        }


def memory_dict(device=None) -> dict:
    """The card's allocator counters (torch.cuda.memory_stats) as a flat
    dict: the measured counterpart of the reference's XLA
    `memory_analysis_dict`.  `peak_bytes` is what dist/policy.py's
    `eval_from_measured` takes as a candidate's peak."""
    import torch
    st = torch.cuda.memory_stats(device)
    return {"peak_bytes": int(st.get("allocated_bytes.all.peak", 0)),
            "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
            "peak_reserved_bytes": int(st.get("reserved_bytes.all.peak", 0))}


# ---------------------------------------------------------------------------
# Bounds and the kernels' work formulas
# ---------------------------------------------------------------------------

def work_bound(work: tuple[dict, int], hw: Hardware = H100) -> tuple[float,
                                                                   str]:
    """Least time (ms) `hw` could take for (flops by dtype, bytes) and what
    bounds it: each input read once and each output written once at the
    HBM rate, or each dtype's operations at its peak, whichever is
    larger."""
    flops, nbytes = work
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = sum(f / hw.rate(dt) for dt, f in flops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_pairs(T: int, window: int, causal: bool, S: int | None = None
                    ) -> int:
    """(query, key) pairs the mask leaves live for T queries over S keys
    (S == T by default), query t at key position t, as the kernel and
    its plain version align them."""
    S = T if S is None else S
    t = np.arange(T)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros_like(t)
    hi = np.minimum(t + 1, S) if causal else np.full_like(t, S)
    return int(np.maximum(hi - lo, 0).sum())


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def fed_agg_work(K: int, n: int, in_size: int, out_size: int):
    """K members of n elements -> one: 2 K n fp32 operations (multiply,
    add); K n inputs read, n outputs written."""
    return {"float32": 2 * K * n}, K * n * in_size + n * out_size


#: per-element operations of the quant8 kernels (fp32, no tensor core):
#: abs, max, divide, round, clamp; multiply
Q8_OPS_PER_ELEMENT = {"quantize": 5, "dequantize": 1}


def quant8_quantize_work(n: int, rows: int, in_size: int):
    """n elements in `rows` rows -> int8 + one fp32 scale a row."""
    return ({"float32": Q8_OPS_PER_ELEMENT["quantize"] * n},
            n * in_size + n + 4 * rows)


def quant8_dequantize_work(n: int, rows: int, out_size: int):
    """int8 + one fp32 scale a row -> n elements of out_size bytes."""
    return ({"float32": Q8_OPS_PER_ELEMENT["dequantize"] * n},
            n + 4 * rows + n * out_size)


def flash_attention_work(B: int, T: int, S: int, H: int, Hkv: int, D: int,
                         window: int, causal: bool, dtype):
    """Q K^T and P V over the live pairs: 4 D FLOPs a pair a head, at the
    inputs' dtype; q read and out written (B T H D), k and v read."""
    item = 2 if _dtype_name(dtype) in ("bfloat16", "float16") else 4
    flops = 4 * D * attention_pairs(T, window, causal, S) * B * H
    return ({_dtype_name(dtype): flops},
            item * (2 * B * T * H * D + 2 * B * S * Hkv * D))


def flash_attention_train_fwd_work(B: int, T: int, H: int, Hkv: int,
                                   D: int, window: int, causal: bool, dtype):
    """flash_attention_work's, and each row's fp32 log-sum-exp written."""
    flops, nbytes = flash_attention_work(B, T, T, H, Hkv, D, window, causal,
                                         dtype)
    return flops, nbytes + 4 * B * H * T


def flash_attention_train_bwd_work(B: int, T: int, H: int, Hkv: int,
                                   D: int, window: int, causal: bool, dtype):
    """S, dP = dO V^T, dV, dK and dQ over the live pairs: 10 D FLOPs a pair
    a head, at the inputs' dtype; q, o and dO read and dq written (B T H D),
    k and v read and dk and dv written, the log-sum-exp read."""
    item = 2 if _dtype_name(dtype) in ("bfloat16", "float16") else 4
    flops = 10 * D * attention_pairs(T, window, causal) * B * H
    return ({_dtype_name(dtype): flops},
            item * (4 * B * T * H * D + 4 * B * T * Hkv * D) + 4 * B * H * T)


def linrec_work(B: int, T: int, D: int, in_size: int, with_h0: bool):
    """h_t = a_t h_{t-1} + b_t: 2 fp32 operations an element; a and b
    read, fp32 h written, h0 read when given."""
    n = B * T * D
    return ({"float32": 2 * n},
            2 * in_size * n + 4 * n + (4 * B * D if with_h0 else 0))
