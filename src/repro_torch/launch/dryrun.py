"""The port's dry run: every (arch x shape x mesh) cell planned and costed
without a card, the counterpart of `repro.launch.dryrun`.

Per cell, on the Hopper production meshes (launch/mesh.py: (32, 8) and
(2, 32, 8)):

  * serve cells (prefill_32k, decode_32k, long_500k) take the policy's
    analytic decision over the (weight layout x cache spec x chunked)
    product (dist/policy.py), as `check_fit` does.  The port has no
    compiler to probe candidates with, so every eval's `source` is
    "analytic";
  * every cell gets the cost walk (dist/cost.py) of its step on meta
    tensors at the cell's GLOBAL shape: prefill, decode (the chosen cache
    spec's cache as input; a chunked decision runs every chunk), or the
    island-stacked `make_fl_train_step` with the config's grad_accum;
  * per device: flops and bytes divided by the mesh's cards, except the
    weight and cache reads, which are taken per device from
    `policy.sharded_bytes` under the chosen layout (the walk reads each
    weight and cache leaf once at its global size; that read is replaced
    by the device's shard), so a replicated cache shows;
  * collective bytes per device come from the layout, as a model of a
    partitioner the port does not have: fsdp and hybrid serving gather
    the decision's `gather_bytes_per_step` over "data"; a
    tensor-parallel layer all-reduces its (tokens per data shard,
    d_model) bf16 activations twice over "model" (four times in a train
    step: forward and backward), a ring all-reduce moving 2 (m - 1) / m
    of them; a train step reduce-scatters and all-gathers its gradients
    over "data", (d - 1) / d of the model shard's bytes each;
  * multi-mesh train cells record `wire_bytes_analytic` of the island
    exchange from `compression.compressed_bytes`, as the reference does;
  * `long_500k` on quadratic archs is `skipped` with the reference's
    reason; a cell whose step cannot be traced is `error` with the
    walk's diagnostic, and `main` exits non-zero.

Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
(`--out DIR` elsewhere); examples/roofline.py and
examples/gen_experiments.py read them.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-20b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
  python -m repro_torch.launch.dryrun --check-fit --mesh both
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

SKIP_REASON = ("full quadratic attention at 524288 tokens; long-context "
               "runs only for ssm/hybrid/windowed archs (DESIGN.md SS6)")


def _cell_path(arch: str, shape: str, mesh: str) -> Path:
    return ARTIFACTS / f"{arch}__{shape}__{mesh}.json"


def _mesh(mesh_kind: str, mesh_spec=None):
    from repro_torch.dist.sharding import AbstractMesh
    from repro_torch.launch.mesh import production_mesh_spec
    spec = mesh_spec or production_mesh_spec
    return AbstractMesh(*spec(multi_pod=(mesh_kind == "multi")))


def collective_model(cfg, shape, sizes: dict, *, layout_gather: float = 0.0,
                     grad_bytes: float = 0.0) -> dict:
    """Per-device collective bytes by mesh axis (see the module
    docstring): the model of a partitioner the port does not have."""
    out = {}
    m = sizes.get("model", 1)
    d = sizes.get("data", 1)
    data_deg = d * sizes.get("pod", 1)
    if layout_gather:
        out["data"] = out.get("data", 0.0) + layout_gather
    layers = cfg.num_layers + getattr(cfg, "enc_layers", 0)
    if m > 1 and cfg.d_model:
        toks = shape.global_batch * (1 if shape.kind == "decode"
                                     else shape.seq_len)
        act = toks / max(data_deg, 1) * cfg.d_model * 2
        per_layer = (4 if shape.kind == "train" else 2) * act * \
            2 * (m - 1) / m
        out["model"] = per_layer * layers
    if shape.kind == "train" and d > 1 and grad_bytes:
        out["data"] = out.get("data", 0.0) + 2 * (d - 1) / d * grad_bytes
    return out


def _entry(step, args, *, n_dev: int, read_global: float,
           read_dev: float, collective: dict, hw) -> dict:
    """Walk one step on meta tensors and take it per device."""
    from repro_torch.dist import cost
    from repro_torch.dist.hardware import Roofline
    t0 = time.perf_counter()
    res = cost.analyze(step, *args)
    walk_s = time.perf_counter() - t0
    flops = {dt: f / n_dev for dt, f in res["flops_by_dtype"].items()}
    nbytes = (res["hbm_bytes"] - read_global) / n_dev + read_dev
    roof = Roofline.of({"hbm_bytes": nbytes, "flops_by_dtype": flops},
                       collective, hw)
    top = sorted(res["by_op"].items(), key=lambda kv: -kv[1]["bytes"])[:12]
    return {"walk_s": round(walk_s, 2),
            "traced": res["out"] is not None,
            "cost_global": {k: res[k] for k in ("flops", "flops_by_dtype",
                                                "hbm_bytes")},
            "cost": {"flops": roof.flops, "flops_by_dtype": flops,
                     "hbm_bytes": nbytes,
                     "collective_bytes": roof.collective_bytes,
                     "collective_by_axis": dict(collective)},
            "weight_cache_read": {"global": read_global, "per_device":
                                  read_dev},
            "by_op_top": dict(top),
            "diagnostics": res["diagnostics"][:20],
            "roofline": roof.as_dict()}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, *, hw=None,
             mesh_spec=None) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import compression, federated
    from repro_torch.dist import hardware
    from repro_torch.dist import policy as dist_policy
    from repro_torch.dist.sharding import (ISLAND_RULES, mesh_sizes,
                                           serve_layout_rules)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import n_islands
    from repro_torch.models import build_model
    from repro_torch.models.config import SHAPES
    from repro_torch.models.param import (ParamDef, abstract_params,
                                          param_bytes)
    from repro_torch.optim import adamw, opt_state_defs
    from repro_torch.tree import tree_map

    hw = hw or hardware.H100
    overrides = dict(overrides or {})
    forced_layout = overrides.pop("_layout", None)
    if forced_layout == "auto":
        forced_layout = None
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)
    shape = SHAPES[shape_name]
    mesh = _mesh(mesh_kind, mesh_spec)
    sizes = mesh_sizes(mesh)
    n_dev = mesh.size
    P = n_islands(mesh)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(sizes), "status": "ok", "hardware": hw.name,
        "n_params": model.n_params, "n_active_params": model.n_active_params,
        "overrides": overrides, "entries": {},
    }
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        result["status"] = "skipped"
        result["reason"] = SKIP_REASON
        return result

    if shape.kind == "train":
        p_defs = model.param_defs()
        o_defs = opt_state_defs(p_defs)
        in_defs = model.input_defs(shape)
        p_dev = dist_policy.sharded_bytes(p_defs, mesh, ISLAND_RULES)
        grad_bytes = p_dev * sizes.get("data", 1)
        read_global = float(param_bytes(p_defs) + param_bytes(o_defs))
        read_dev = p_dev + dist_policy.sharded_bytes(o_defs, mesh,
                                                     ISLAND_RULES)
        if P > 1:
            def island(d, batch=False):
                lead = (P, d.shape[0] // P) if batch else (P,)
                rest = d.shape[1:] if batch else d.shape
                return ParamDef(lead + rest, d.dtype,
                                ("island",) + d.logical_axes, d.init,
                                d.fan_in_axes)
            p_defs = tree_map(island, p_defs)
            o_defs = tree_map(island, o_defs)
            in_defs = tree_map(lambda d: island(d, batch=True), in_defs)
            read_global *= P
        step = S.make_fl_train_step(model, adamw(1e-4), P)
        args = tuple(abstract_params(d) for d in (p_defs, o_defs, in_defs))
        result["entries"]["train_step"] = _entry(
            step, args, n_dev=n_dev, read_global=read_global,
            read_dev=read_dev, hw=hw,
            collective=collective_model(cfg, shape, sizes,
                                        grad_bytes=grad_bytes))
        if P > 1:
            params = args[0]
            result["entries"]["fl_aggregate"] = {"wire_bytes_analytic": {
                "raw_storage": compression.compressed_bytes(params,
                                                            mode="none")}}
            result["entries"]["fl_aggregate_q8"] = {"wire_bytes_analytic": {
                "q8_rowwise": compression.compressed_bytes(
                    params, mode="q8_rowwise"),
                "q8_wire_blockwise": compression.compressed_bytes(
                    params, mode="q8"),
                "q8_topk_wire": compression.compressed_bytes(
                    params, mode="q8_topk")}}
            mixing = torch.empty((P, P), dtype=torch.float32, device="meta")
            agg = _entry(federated.fl_aggregate, (params, mixing),
                         n_dev=n_dev, read_global=0.0, read_dev=0.0, hw=hw,
                         collective={})
            result["entries"]["fl_aggregate"].update(agg)
        else:
            result["entries"]["fl_aggregate"] = {
                "note": "single island on the single-pod mesh: the "
                        "exchange is an identity; costed on the multi-pod "
                        "mesh"}
        _mark_error(result)
        return result

    # prefill / decode: the analytic (weight layout x cache spec) decision
    B, Sq = shape.global_batch, shape.seq_len
    if forced_layout:
        decision = None
        layout, cache_spec, chunked = forced_layout, "", False
        result["layout_decision"] = {"layout": forced_layout,
                                     "reason": "forced by override"}
        ev = dist_policy.analytic_eval(model, shape, mesh, forced_layout,
                                       hw=hw)
    else:
        decision = dist_policy.analytic_serve_decision(model, shape, mesh,
                                                       hw=hw)
        layout, cache_spec, chunked = (decision.layout, decision.cache_spec,
                                       decision.chunked)
        result["layout_decision"] = decision.as_dict()
        ev = decision.chosen
    rules = serve_layout_rules(layout)
    m = model
    if cache_spec and model.supports_cache_spec \
            and cache_spec != cfg.cache_spec:
        m = build_model(dataclasses.replace(cfg, cache_spec=cache_spec))
    p_defs = m.param_defs()
    read_global = float(param_bytes(p_defs))
    read_dev = dist_policy.sharded_bytes(p_defs, mesh, rules)
    params = abstract_params(p_defs)
    base = "prefill_step" if shape.kind == "prefill" else "decode_step"
    if chunked:
        C = dist_policy.CHUNK_TOKENS
        c_defs = m.cache_defs(B, Sq)
        cache = abstract_params(c_defs)
        chunk = S.make_chunk_prefill_step(m)

        def step(params, cache):
            for s0 in range(0, Sq, C):
                pos = torch.arange(s0, s0 + C, dtype=torch.int32,
                                   device="meta")
                batch = {"tokens": torch.empty((B, C), dtype=torch.int32,
                                               device="meta"),
                         "positions": pos.expand(B, C),
                         "last_index": torch.empty((B,), dtype=torch.int32,
                                                   device="meta")}
                nxt, cache = chunk(params, batch, cache)
            return nxt, cache
        args = (params, cache)
        base = "chunk_prefill_step"
    elif shape.kind == "prefill":
        step = S.make_prefill_step(m)
        args = (params, abstract_params(m.input_defs(shape)))
    else:
        c_defs = m.cache_defs(B, Sq)
        read_global += float(param_bytes(c_defs))
        read_dev += dist_policy.sharded_bytes(c_defs, mesh, rules)
        step = S.make_decode_step(m)
        args = (params, abstract_params(m.input_defs(shape)),
                abstract_params(c_defs))
    gather = ev.detail.get("gather_bytes_per_step", 0.0) * \
        ev.detail.get("n_chunks", 1)
    result["entries"][base] = _entry(
        step, args, n_dev=n_dev, read_global=read_global, read_dev=read_dev,
        hw=hw, collective=collective_model(cfg, shape, sizes,
                                           layout_gather=gather))
    result["entries"][base]["layout"] = layout
    result["entries"][base]["cache_spec"] = cache_spec
    _mark_error(result)
    return result


def _mark_error(result: dict):
    """A cell with an entry the walk could not trace is an error."""
    bad = [(name, e["diagnostics"]) for name, e in result["entries"].items()
           if e.get("traced") is False]
    if bad:
        result["status"] = "error"
        result["traceback"] = "; ".join(f"{name}: {diag}"
                                        for name, diag in bad)


# ---------------------------------------------------------------------------
# The CLI: one subprocess per cell
# ---------------------------------------------------------------------------

def all_cells(meshes=("single", "multi")) -> list[tuple[str, str, str]]:
    from repro_torch.configs import list_archs
    from repro_torch.models.config import SHAPES
    return [(arch, shape, mesh) for arch in list_archs(assigned_only=True)
            for shape in SHAPES
            for mesh in meshes]


def check_fit(meshes=("single", "multi"), *, hw=None, mesh_spec=None) -> int:
    """Analytic CI gate: every serve cell must have >=1 fitting (weight
    layout x cache spec) product on the production meshes (`mesh_spec`
    and `hw` take others)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.dist import policy as dist_policy
    from repro_torch.models import build_model
    from repro_torch.models.config import SHAPES
    bad = []
    for mesh_kind in meshes:
        mesh = _mesh(mesh_kind, mesh_spec)
        for arch in list_archs(assigned_only=True):
            cfg = get_config(arch)
            if cfg.family == "cnn":
                continue
            model = build_model(cfg)
            for shape_name, shape in SHAPES.items():
                if shape.kind == "train":
                    continue
                if shape_name == "long_500k" and not cfg.sub_quadratic:
                    continue
                d = dist_policy.analytic_serve_decision(model, shape, mesh,
                                                        hw=hw)
                print(f"[check-fit] {mesh_kind:6s} {arch:22s} "
                      f"{shape_name:12s} {d.key:30s} "
                      f"peak={d.chosen.hbm_bytes/1e9:7.2f} GB "
                      f"{'ok' if d.fits else 'NO-FIT'}", flush=True)
                if not d.fits:
                    bad.append((arch, shape_name, mesh_kind))
    if bad:
        print(f"[check-fit] {len(bad)} cells with NO fitting "
              f"(layout, cache) product: {bad}", flush=True)
        return 1
    print("[check-fit] every serve cell has >=1 fitting (weight, cache) "
          "layout", flush=True)
    return 0


def main(argv=None):
    global ARTIFACTS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--check-fit", action="store_true",
                    help="analytic only: assert every serve cell has >=1 "
                         "fitting (weight layout x cache spec) product")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig overrides; "
                         "'_layout' forces a serve layout")
    ap.add_argument("--tag", default=None,
                    help="artifact filename suffix for override sweeps")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default artifacts/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    if args.out:
        ARTIFACTS = Path(args.out)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    if args.check_fit:
        sys.exit(check_fit(meshes))

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = all_cells(meshes)
        todo = [c for c in cells if args.force or not _cell_path(*c).exists()]
        print(f"[dryrun] {len(todo)}/{len(cells)} cells to run", flush=True)
        failures = []
        for i, (arch, shape, mesh) in enumerate(todo):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(ARTIFACTS)]
            print(f"[dryrun {i+1}/{len(todo)}] {arch} {shape} {mesh}",
                  flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append((arch, shape, mesh))
                print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
        print(f"[dryrun] done; {len(failures)} failures: {failures}",
              flush=True)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --check-fit)")
    overrides = json.loads(args.overrides) if args.overrides else None
    code = 0
    for mesh in meshes:
        try:
            res = run_cell(args.arch, args.shape, mesh, overrides)
        except Exception:
            res = {"arch": args.arch, "shape": args.shape, "mesh": mesh,
                   "status": "error", "traceback": traceback.format_exc()}
        code |= _write(res, args.tag)
    sys.exit(code)


def _write(res: dict, tag: str | None) -> int:
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}"
    if tag:
        name += f"__{tag}"
    out = ARTIFACTS / f"{name}.json"
    out.write_text(json.dumps(res, indent=2, default=str))
    print(json.dumps({k: v for k, v in res.items() if k != "entries"},
                     indent=2, default=str)[:4000])
    if "layout_decision" in res:
        d = res["layout_decision"]
        cs = d.get("cache_spec", "")
        print(f"  layout={d['layout']}" + (f" cache={cs}" if cs else "")
              + (" chunked" if d.get("chunked") else "")
              + f" ({d.get('reason', '')})")
    for ename, e in res.get("entries", {}).items():
        if "roofline" in e:
            r = e["roofline"]
            print(f"  {ename}: dominant={r['dominant']} "
                  f"t_comp={r['t_compute_s']:.2e}s "
                  f"t_mem={r['t_memory_s']:.2e}s "
                  f"t_coll={r['t_collective_s']:.2e}s (walk {e['walk_s']}s)")
    print(f"  -> {out}")
    if res["status"] == "error":
        print(str(res.get("traceback", ""))[-3000:])
        return 1
    return 0


if __name__ == "__main__":
    main()
