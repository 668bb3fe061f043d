"""The planning tables of the JAX harness's `scripts/gen_experiments.py`,
rendered from the port's dry-run artifacts (artifacts/dryrun_torch/,
`python -m repro_torch.launch.dryrun --all --mesh both`):

  * the sweep's health (traced / skipped / errored, walk times);
  * per-cell roofline tables (single and multi mesh) with the layout;
  * the layout policy's decisions: chosen layout and cache spec, peak
    memory a device, headroom, and each baseline layout's peak;
  * the island exchange (fl_aggregate) on the multi mesh;
  * the cost walk's calibration: its meta totals against the same walk
    on the card (the counterpart of the reference's HLO-vs-XLA table),
    from a JSON record `chip_smoke.py` phase (d) writes (`--walks`).

It prints markdown, or writes it to `--out`; it never rewrites
EXPERIMENTS.md.  The exchange, serve and faults sections of the JAX
script render benchmark records and wait for the port's benchmark.

  PYTHONPATH=src python -m repro_torch.examples.gen_experiments \\
      [--dir DIR] [--walks FILE] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.examples import roofline as R


def sweep_summary(directory=None) -> str:
    parts = []
    for mesh in ("single", "multi"):
        ok = skip = err = 0
        walks = []
        for rec in R.load_cells(mesh, directory=directory):
            if rec["status"] == "ok":
                ok += 1
                walks += [e["walk_s"] for e in rec["entries"].values()
                          if "walk_s" in e]
            elif rec["status"] == "skipped":
                skip += 1
            else:
                err += 1
        line = f"* `{mesh}` mesh: {ok} traced, {skip} documented skips, " \
               f"{err} errors"
        if walks:
            walks.sort()
            line += (f"; per-step walk time min/median/max = "
                     f"{walks[0]:.1f}/{walks[len(walks) // 2]:.1f}/"
                     f"{walks[-1]:.1f}s")
        parts.append(line)
    return "\n".join(parts)


def layout_table(directory=None) -> str:
    out = ["| arch | shape | mesh | layout | cache | fits | peak GB/dev | "
           "headroom GB | stationary | hybrid | fsdp | why |\n",
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n"]
    n_cells = n_fit = 0
    cap_gb = None

    def ckey(c):
        return (c["layout"] + (f"+{c['cache']}" if c.get("cache") else "")
                + ("+chunked" if c.get("chunked") else ""))

    for mesh in ("single", "multi"):
        for rec in R.load_cells(mesh, directory=directory):
            ld = rec.get("layout_decision")
            if not ld or "candidates" not in ld:
                continue
            n_cells += 1
            n_fit += bool(ld["fits"])
            cap_gb = ld["budget_gb"] * ld["margin"]
            # each layout's column: its head/bf16 (or spec-less) candidate
            base = {}
            for c in ld["candidates"]:
                if not c.get("chunked") and c.get("cache", "head/bf16") \
                        in ("", "head/bf16"):
                    base.setdefault(c["layout"], c)
            dkey = (ld["layout"] + (f"+{ld['cache_spec']}"
                                    if ld.get("cache_spec") else "")
                    + ("+chunked" if ld.get("chunked") else ""))
            chosen = next(c for c in ld["candidates"] if ckey(c) == dkey)
            peak = {k: f"{c['hbm_gb']:.2f}" for k, c in base.items()}
            why = ("fastest feasible step" if ld["fits"]
                   else "nothing fits; min peak")
            if ld["fits"] and ld.get("cache_spec") not in (None, "",
                                                           "head/bf16"):
                why = "cache spec: head/bf16 over the cap or slower"
            out.append(
                f"| {rec['arch']} | {rec['shape']} | {mesh} | "
                f"**{ld['layout']}** | "
                f"{(ld.get('cache_spec') or '--')}"
                f"{' +chunked' if ld.get('chunked') else ''} | "
                f"{'yes' if ld['fits'] else 'NO'} | "
                f"{chosen['hbm_gb']:.2f} | {ld['headroom_gb']:.2f} | "
                f"{peak.get('stationary', '--')} | "
                f"{peak.get('hybrid', '--')} | {peak.get('fsdp', '--')} | "
                f"{why} |\n")
    if cap_gb is not None:
        out.append(f"\n{n_fit}/{n_cells} serve cells fit under the "
                   f"{cap_gb:.1f} GB cap (margin x device memory, from the "
                   f"recorded decisions).\n")
    return "".join(out)


def fl_agg_table(directory=None) -> str:
    out = ["| arch | t_coll (ms) | t_mem (ms) | raw wire GB | q8 rowwise "
           "wire GB |\n|---|---|---|---|---|\n"]
    for rec in R.load_cells("multi", directory=directory):
        e = rec.get("entries", {}).get("fl_aggregate", {})
        q8 = rec.get("entries", {}).get("fl_aggregate_q8", {})
        if rec["status"] != "ok" or "roofline" not in e:
            continue
        r = e["roofline"]
        raw = e["wire_bytes_analytic"]["raw_storage"]
        rw = q8.get("wire_bytes_analytic", {}).get("q8_rowwise", 0)
        out.append(
            f"| {rec['arch']} | {r['t_collective_s'] * 1e3:.1f} | "
            f"{r['t_memory_s'] * 1e3:.1f} | {raw / 1e9:.2f} | "
            f"{rw / 1e9:.2f} |\n")
    return "".join(out)


def calibration_table(walks: dict | None) -> str:
    """The walk's meta totals against the card's, per step: flops by
    dtype and bytes must agree exactly; bound and measured time beside."""
    if not walks:
        return ("No record of the walk on the card: `chip_smoke.py` phase "
                "(d) writes one (`--walks`).\n")
    out = ["| step | meta GFLOP (by dtype) | card GFLOP | meta GB | card "
           "GB | equal | bound (s) | measured (s) | share | dominant |\n",
           "|---|---|---|---|---|---|---|---|---|---|\n"]
    for name, w in walks.items():
        fm = ", ".join(f"{dt} {f / 1e9:.1f}" for dt, f in
                       sorted(w["meta"]["flops_by_dtype"].items()))
        fc = sum(w["card"]["flops_by_dtype"].values()) / 1e9
        out.append(
            f"| {name} | {fm} | {fc:.1f} | "
            f"{w['meta']['hbm_bytes'] / 1e9:.2f} | "
            f"{w['card']['hbm_bytes'] / 1e9:.2f} | "
            f"{'yes' if w['equal'] else 'NO'} | {w['bound_s']:.4f} | "
            f"{w['measured_s']:.4f} | {w['bound_s'] / w['measured_s']:.3f} "
            f"| {w['dominant']} |\n")
    return "".join(out)


def render(directory=None, walks: dict | None = None) -> str:
    single = R.markdown_table(
        [r for r in (R.cell_row(c) for c in
                     R.load_cells("single", directory=directory)) if r])
    multi = R.markdown_table(
        [r for r in (R.cell_row(c) for c in
                     R.load_cells("multi", directory=directory)) if r])
    return (f"## Dry run of the port (H100 meshes)\n\n"
            f"{sweep_summary(directory)}\n\n"
            f"## Layout policy decisions\n\n{layout_table(directory)}\n"
            f"## Roofline, single mesh (32 x 8)\n\n{single}\n"
            f"## Roofline, multi mesh (2 x 32 x 8)\n\n{multi}\n"
            f"## Island exchange (multi mesh)\n\n{fl_agg_table(directory)}\n"
            f"## Cost walk: meta against the card\n\n"
            f"{calibration_table(walks)}")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="artifact directory (default artifacts/"
                         "dryrun_torch)")
    ap.add_argument("--walks", default=None,
                    help="JSON of the cost walk on meta and on the card")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    walks = json.loads(Path(args.walks).read_text()) if args.walks else None
    text = render(args.dir, walks)
    if args.out:
        Path(args.out).write_text(text)
        print(f"wrote {args.out} ({len(text)} bytes)")
    else:
        print(text)
    return text


if __name__ == "__main__":
    main()
