"""Logical-axis -> mesh-axis sharding resolution, port of
`repro.dist.sharding`.

Models annotate tensors with LOGICAL axis names ("batch", "embed", "ffn",
"heads", ...).  A RuleSet maps each logical name to an ordered list of
candidate mesh axes; `logical_to_mesh_spec` resolves one tensor's logical
axes against a mesh, enforcing:

  * divisibility  -- a mesh axis is only used when the dim size divides
                     evenly; otherwise the next candidate (or None) is used;
  * axis-used-once -- each mesh axis appears at most once per tensor;
                     priority dims (heads/kv_heads) claim first, then
                     position order breaks ties;
  * explicit axes -- a logical entry may itself be a tuple of MESH axis
                     names (e.g. ("model",) for sequence/context
                     parallelism), resolved verbatim before any rule.

The resolution is host logic and gives the reference's specs exactly.
PyTorch has no PartitionSpec, so `PartitionSpec` here is a tuple whose
entries are None, a mesh axis name, or a tuple of names stacked on one
tensor dim.  A mesh is anything with a `.shape` mapping axis name -> size
in axis order (`AbstractMesh`, the counterpart of the reference's
`abstract_mesh`), or a `torch.distributed.device_mesh.DeviceMesh`, whose
names are its `mesh_dim_names`; `mesh_sizes` reads either.
`placements(spec, mesh)` gives a spec's `Shard(dim)` / `Replicate()` list
over a DeviceMesh: the DTensor counterpart of a NamedSharding.

Eager PyTorch has no `with mesh:`, so `use_mesh(mesh)` holds the ambient
mesh and `use_rules(rules)` the ambient rules.  `constrain(x, axes)` is a
no-op without an ambient mesh; with one it resolves the spec (so
fallbacks are recorded and warned as in the reference) and redistributes
a DTensor, and returns any other tensor as it is.

The port's model code does NOT call `constrain`.  The reference's 24 call
sites in its models run once, when a step is traced; eager PyTorch would
resolve a spec per call per step, on decode and train paths that are
already bound by the host issuing kernels.  The layout a decision picks
reaches the port through the cache spec it chooses and the bytes the
policy predicts, not through per-op constraints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings


class ShardingFallbackWarning(UserWarning):
    """A PRIORITY logical dim (heads / kv_heads) could not claim its mesh
    axis (divisibility or axis-used-once failed) and the dim fell back to
    replication: the footgun that replicates a decode cache of a model
    whose kv heads do not divide the model axis (qwen1.5-4b's 20).  The
    resolution still proceeds; the warning and the FallbackRecord in the
    caller's `report` make it visible."""


@dataclasses.dataclass(frozen=True)
class FallbackRecord:
    """One recorded resolution fallback (see logical_to_mesh_spec)."""
    logical: str                  # logical dim name, e.g. "kv_heads"
    dim: int                      # tensor dim size that failed to shard
    shape: tuple                  # full tensor shape
    candidates: tuple             # mesh axes the rule offered
    reason: str                   # "indivisible" | "axis_taken"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# warn once per distinct (logical, dim, reason, mesh axis sizes)
_warned_fallbacks: set = set()


class PartitionSpec(tuple):
    """Per tensor dim: None, a mesh axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes, no devices: what the analytic policy and
    the dry run resolve against (the counterpart of jax's AbstractMesh)."""

    def __init__(self, axis_sizes, axis_names):
        sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for axes {names}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

class RuleSet(dict):
    """logical axis name -> ordered tuple of candidates.

    A candidate is either a mesh axis name (str) or a tuple of mesh axis
    names to be stacked greedily (longest divisible prefix wins).
    `priority` lists logical dims that claim their mesh axes before the
    rest of the tensor (attention heads beat ffn for the "model" axis).
    """

    def __init__(self, mapping=(), priority=("heads", "kv_heads"), **kw):
        super().__init__(mapping, **kw)
        self.priority = tuple(priority)

    def replacing(self, **kw) -> "RuleSet":
        new = RuleSet(self, priority=self.priority)
        new.update(kw)
        return new


DEFAULT_RULES = RuleSet({
    "batch": (("pod", "data"),),
    "island": ("pod",),
    "layers": (),                    # the layer stack: never sharded
    "embed": ("data",),              # FSDP shard of the d_model dim
    "embed_tp": ("model", "data"),   # output-projection d_model dim
    "ffn": ("model",),
    "expert_ffn": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model", "data"),
    "ssm_inner": ("model",),
    "lru_width": ("model",),
})

# FL islands: `pod` belongs to the island axis, batch must not touch it.
ISLAND_RULES = DEFAULT_RULES.replacing(batch=("data",))

# Serving: stationary weights, tensor-parallel only (no FSDP over "data").
SERVE_RULES = DEFAULT_RULES.replacing(
    embed=(), embed_tp=("model",), vocab=("model",))

# Hybrid serving: body weights stationary (TP-only, like SERVE_RULES), the
# embedding / lm_head tables (the only leaves with a "vocab" dim) also
# sharded over "data".
HYBRID_SERVE_RULES = SERVE_RULES.replacing(vocab=(("model", "data"),))

#: serve layout name -> RuleSet, in decreasing weight-stationarity; the
#: layout policy (dist/policy.py) picks between these.
SERVE_LAYOUTS = {
    "stationary": SERVE_RULES,
    "hybrid": HYBRID_SERVE_RULES,
    "fsdp": DEFAULT_RULES,
}


def serve_layout_rules(layout: str) -> RuleSet:
    """RuleSet for a named serve layout (see SERVE_LAYOUTS)."""
    try:
        return SERVE_LAYOUTS[layout]
    except KeyError:
        raise KeyError(f"unknown serve layout '{layout}'; "
                       f"known: {sorted(SERVE_LAYOUTS)}") from None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def mesh_sizes(mesh) -> dict:
    """{axis name: size} in axis order, for an AbstractMesh (or anything
    whose `.shape` maps names to sizes) and for a DeviceMesh (a tuple
    `.shape`, names in `mesh_dim_names`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    shape = mesh.shape
    if names is not None and not isinstance(shape, dict):
        return {str(k): int(v) for k, v in zip(names, tuple(shape))}
    return {str(k): int(v) for k, v in dict(shape).items()}


def logical_to_mesh_spec(logical_axes, shape, mesh,
                         rules: RuleSet | None = None,
                         report: list | None = None) -> PartitionSpec:
    """Resolve one tensor's logical axes to a PartitionSpec for `mesh`.

    logical_axes: per-dim entries -- a logical name, None, or an explicit
        tuple of mesh axis names.  Must match len(shape).
    report: optional list; a FallbackRecord is appended for every PRIORITY
        dim that had a live candidate axis but resolved to None
        (replication).  A ShardingFallbackWarning is emitted once per
        distinct (logical, dim, mesh) either way.
    """
    rules = DEFAULT_RULES if rules is None else rules
    if len(logical_axes) != len(shape):
        raise ValueError(f"rank mismatch: axes {logical_axes} vs "
                         f"shape {shape}")
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list = [None] * len(shape)

    def claim_stack(names, dim):
        """Longest prefix of `names` (present, unused) whose cumulative
        product divides `dim`."""
        picked, prod = [], 1
        for nm in names:
            if nm not in sizes or nm in used:
                continue
            if dim % (prod * sizes[nm]) == 0:
                picked.append(nm)
                prod *= sizes[nm]
            else:
                break
        return picked

    def emit(picked):
        for nm in picked:
            used.add(nm)
        if not picked:
            return None
        return picked[0] if len(picked) == 1 else tuple(picked)

    def resolve_rule(name, dim):
        for cand in rules.get(name, ()):
            if isinstance(cand, (tuple, list)):
                picked = claim_stack(cand, dim)
                if picked:
                    return emit(picked)
            elif cand in sizes and cand not in used and dim % sizes[cand] == 0:
                return emit([cand])
        return None

    def note_fallback(name, dim):
        """A priority dim resolved to None: was a candidate axis live?
        Axes claimed by an explicit pass-0 tuple don't count -- the
        caller chose that placement (the ring cache gives "model" to the
        seq dim instead of kv_heads)."""
        cands, reason = [], None
        for cand in rules.get(name, ()):
            for ax in (cand if isinstance(cand, (tuple, list)) else (cand,)):
                if ax not in sizes or sizes[ax] <= 1 or ax in explicit:
                    continue
                cands.append(ax)
                reason = "axis_taken" if ax in used else "indivisible"
        if reason is None:
            return
        rec = FallbackRecord(name, dim, tuple(shape), tuple(cands), reason)
        if report is not None:
            report.append(rec)
        key = (name, dim, reason, tuple(sorted(sizes.items())))
        if key not in _warned_fallbacks:
            _warned_fallbacks.add(key)
            warnings.warn(
                f"priority dim '{name}' (size {dim}, tensor {tuple(shape)}) "
                f"cannot shard over {cands} ({reason}: "
                f"{ {a: sizes[a] for a in cands} }) and REPLICATES -- "
                f"consider a seq-sharded ring cache spec "
                f"(models/cache.py) for decode caches",
                ShardingFallbackWarning, stacklevel=3)

    # Pass 0: explicit mesh-axis tuples bind first (caller knows best).
    explicit: set[str] = set()
    for i, ax in enumerate(logical_axes):
        if isinstance(ax, (tuple, list)):
            entries[i] = emit(claim_stack(ax, shape[i]))
            explicit.update(used)
    # Pass 1: priority logical dims; Pass 2: everything else, in position
    # order.
    for wave in (rules.priority, None):
        for i, ax in enumerate(logical_axes):
            if not isinstance(ax, str) or entries[i] is not None:
                continue
            if wave is not None and ax not in wave:
                continue
            if wave is None and ax in rules.priority:
                continue
            entries[i] = resolve_rule(ax, shape[i])
            if wave is not None and entries[i] is None:
                note_fallback(ax, shape[i])
    return PartitionSpec(*entries)


def placements(spec, mesh) -> list:
    """The `torch.distributed.tensor` placements of `spec` over `mesh`,
    one per mesh dim: Shard(tensor dim) where a spec entry names the
    mesh dim (a stacked entry shards one tensor dim over each of its
    mesh dims), Replicate() elsewhere.  DTensor splits a dim over its
    mesh dims in mesh-dim order; a stack named in another order (the
    hybrid layout's ("model", "data") on a ("data", "model") mesh) puts
    the same bytes on each device, in another device order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(dim)
    return out


def spec_tree_for(defs, mesh, rules: RuleSet | None = None):
    """ParamDef tree -> PartitionSpec tree (pass each through `placements`
    for a DeviceMesh)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda d: logical_to_mesh_spec(d.logical_axes, d.shape,
                                                   mesh, rules), defs)


# ---------------------------------------------------------------------------
# Ambient mesh + rules
# ---------------------------------------------------------------------------

_state = threading.local()


def current_rules() -> RuleSet:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(rules: RuleSet):
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def ambient_mesh():
    """The mesh of the enclosing `use_mesh` context, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Hold `mesh` as the ambient mesh (the reference's `with mesh:`)."""
    prev = ambient_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axis_size(name: str) -> int:
    """Size of `name` in the ambient mesh (1 when absent / no mesh)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    return mesh_sizes(mesh).get(name, 1)


def constrain(x, logical_axes):
    """Resolve `x`'s spec against the ambient mesh and rules, and
    redistribute `x` to it when `x` is a DTensor on a DeviceMesh; any
    other tensor comes back as it is.  No-op without an ambient mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    spec = logical_to_mesh_spec(logical_axes, tuple(x.shape), mesh,
                                current_rules())
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    return x
