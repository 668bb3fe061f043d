"""Roofline tables from the port's dry-run artifacts, the counterpart of
the JAX harness's `benchmarks/roofline.py`.

Reads artifacts/dryrun_torch/*.json (`python -m repro_torch.launch.dryrun
--all --mesh both`) and gives per arch x shape x mesh the three terms,
the dominant one, the MODEL_FLOPS / walked-FLOPs usefulness ratio and the
layout.

Conventions:
  * flops / bytes / collective bytes are PER DEVICE, from the cost walk
    (dist/cost.py) at the cell's global shape, as launch/dryrun.py takes
    them per device;
  * MODEL_FLOPS = 6 N D (train) or 2 N D (prefill, decode), N the
    active params for MoE, D the tokens a step processes;
  * hardware: the H100 model of dist/hardware.py (989 TFLOP/s bf16, 67
    TFLOP/s fp32, 3.35 TB/s HBM, 50 GB/s a GPU across nodes, 450 GB/s
    NVLink): the terms are recomputed here from each entry's per-device
    cost.

  PYTHONPATH=src python -m repro_torch.examples.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.dist.hardware import Roofline

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

SHAPE_TOKENS = {  # (tokens per step, flops multiplier per param per token)
    "train_4k": (4096 * 256, 6),
    "prefill_32k": (32768 * 32, 2),
    "decode_32k": (1 * 128, 2),
    "long_500k": (1 * 1, 2),
}

ENTRY = {"train_4k": "train_step", "prefill_32k": "prefill_step",
         "decode_32k": "decode_step", "long_500k": "decode_step"}


def model_flops(rec: dict) -> float:
    toks, mult = SHAPE_TOKENS[rec["shape"]]
    return mult * rec["n_active_params"] * toks


def load_cells(mesh: str = "single", tag: str | None = None,
               directory: Path | None = None) -> list[dict]:
    rows = []
    suffix = f"__{mesh}" + (f"__{tag}" if tag else "") + ".json"
    for f in sorted(Path(directory or ARTIFACTS).glob(f"*{suffix}")):
        if tag is None and f.name.count("__") != 2:
            continue
        rows.append(json.loads(f.read_text()))
    return rows


def devices(rec) -> int:
    n = 1
    for v in rec["mesh_shape"].values():
        n *= v
    return n


def cell_row(rec: dict, entry_name: str | None = None) -> dict | None:
    if rec["status"] == "skipped":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": "skipped",
                "reason": rec.get("reason", "")[:60]}
    if rec["status"] != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": "error"}
    entries = rec["entries"]
    entry_name = entry_name or ENTRY[rec["shape"]]
    if entry_name not in entries and "chunk_prefill_step" in entries:
        entry_name = "chunk_prefill_step"
    e = entries[entry_name]
    r = Roofline.of(e["cost"], e["cost"]["collective_by_axis"]).as_dict()
    mf = model_flops(rec)
    useful = mf / devices(rec) / max(e["cost"]["flops"], 1e-9)
    ld = rec.get("layout_decision") or {}
    chosen = next((c for c in ld.get("candidates", [])
                   if c["layout"] == ld.get("layout")
                   and c.get("cache", "") == ld.get("cache_spec", "")
                   and bool(c.get("chunked")) == bool(ld.get("chunked"))),
                  None)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": "ok", "entry": entry_name,
        "layout": ld.get("layout", ""),
        "cache_spec": ld.get("cache_spec", ""),
        "layout_fits": ld.get("fits"),
        "layout_headroom_gb": ld.get("headroom_gb"),
        "layout_reason": ld.get("reason", ""),
        "layout_candidates": ld.get("candidates", []),
        "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
        "t_collective_s": r["t_collective_s"], "dominant": r["dominant"],
        "bound_s": r["bound_s"], "model_flops": mf, "useful_ratio": useful,
        "roofline_fraction": r["t_compute_s"] / max(r["bound_s"], 1e-30)
        * useful,
        "hbm_gb_per_dev": (chosen["hbm_bytes"] / 1e9 if chosen else None),
        "coll_by_axis": {k: round(v / 1e9, 3) for k, v in
                         e["cost"]["collective_by_axis"].items()},
    }


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant "
           "| useful FLOPs | roofline frac | mem GB/dev | layout |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | -- | -- | -- | "
                       f"{r['status']}: {r.get('reason', '')} | -- | -- | "
                       f"-- | -- |\n")
            continue
        layout = r.get("layout") or "--"
        if r.get("cache_spec"):
            layout += f"+{r['cache_spec']}"
        if layout != "--" and r.get("layout_fits") is False:
            layout += " (!fit)"
        mem = r["hbm_gb_per_dev"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3g} | "
            f"{r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{'--' if mem is None else f'{mem:.1f}'} | {layout} |\n")
    return "".join(out)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="artifact directory (default artifacts/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    rows = []
    print("name,us_per_call,derived")
    for mesh in ("single", "multi"):
        for rec in load_cells(mesh, directory=args.dir):
            r = cell_row(rec)
            if r is None:
                continue
            rows.append(r)
            if r["status"] != "ok":
                print(f"roofline.{r['arch']}.{r['shape']}.{mesh},0,"
                      f"{r['status']}")
                continue
            print(f"roofline.{r['arch']}.{r['shape']}.{mesh},"
                  f"{r['bound_s'] * 1e6:.0f},"
                  f"dom={r['dominant']};useful={r['useful_ratio']:.2f};"
                  f"frac={r['roofline_fraction']:.3f}")
    return rows


if __name__ == "__main__":
    main()
