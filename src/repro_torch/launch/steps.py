"""Step factories, port of `repro.launch.steps`: the losses (`lm_loss`,
`cnn_loss`), the island train step (`make_train_step`) and its
island-stacked form (`make_fl_train_step`), the island exchange
(`make_fl_aggregate`) and the serve steps (`make_prefill_step`,
`make_chunk_prefill_step`, `make_decode_step`).

A train step updates the params and the optimizer state IN PLACE (the
reference's jitted step returns new trees) and returns them.  Its
gradients are taken with `torch.autograd.grad` over one leaf per piece:
an unstacked leaf, or one layer's slice of a stacked (L, ...) leaf, a
view of the stack's storage (`param.LayerSlices`), so no layer's
gradient is a full-size (L, ...) tensor.  The gradient's norm is one
fp32 reduction over all pieces before any update; the clip and the
optimizer's update then stream piece by piece (`Optimizer.step_`).  A
call that carries a gradient takes the training kernels for attention on
the card where they take its inputs (`layers.select_attention`:
`flash_attention_train`, a forward that saves the row log-sum-exp and a
hand-written backward; bf16 heads of 33 to 128 on the TMA route), and the
reference's plain attention and scan routes otherwise (`ssm._scan`: no
linrec launch happens in training).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch import spans
from repro_torch.core import federated
from repro_torch.models.param import STACKED, LayerSlices
from repro_torch.optim.optimizers import clip_scale, global_norm, moment_names
from repro_torch.tree import leaves, tree_map


def lm_loss(model, params, batch):
    """Mean token cross entropy (the VLM's patch positions masked out)
    plus 0.01 x the MoE load-balance loss -> (total, {xent, aux})."""
    logits, aux = model.apply(params, batch, mode="train")
    labels = batch["labels"]
    cfg = model.cfg
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # the gold logit by a masked reduction, as the reference takes it
    iota = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.where(iota == labels[..., None], lf, 0.0).sum(dim=-1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=lf.device)
    if cfg.frontend == "vision_stub":   # patch positions carry no labels
        mask[:, :cfg.frontend_len].fill_(0.0)
    xent = ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = xent + 0.01 * aux
    return total, {"xent": xent,
                   "aux": torch.as_tensor(aux, dtype=torch.float32,
                                          device=lf.device)}


def cnn_loss(model, params, batch):
    logits, _ = model.apply(params, batch, mode="train")
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, batch["labels"].long()[..., None])[..., 0]
    xent = (lse - gold).mean()
    return xent, {"xent": xent,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=lf.device)}


def _loss_for(model):
    return cnn_loss if model.cfg.family == "cnn" else lm_loss


def pieces(tree) -> list:
    """The leaves of a param-shaped tree with each stacked subtree (a
    `param.STACKED` key) split into its layers' slices (views), layer by
    layer: the pieces a train step differentiates and updates, in one
    order for the params, their moments and their gradients."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k in STACKED and isinstance(v, dict):
            ls = leaves(v)
            out += [l[i] for i in range(ls[0].shape[0]) for l in ls]
        else:
            out += leaves(v)
    return out


def grad_view(params):
    """(tree, leaves): `params` with every piece a detached leaf that
    requires grad (a view of the same storage), stacked subtrees given
    as `LayerSlices`, and those leaves in `pieces` order."""
    tree, flat = {}, []
    for k in sorted(params):
        v = params[k]
        if k in STACKED and isinstance(v, dict):
            n = leaves(v)[0].shape[0]
            tree[k] = LayerSlices(
                tree_map(lambda a: a[i].detach().requires_grad_(), v)
                for i in range(n))
            for lt in tree[k]:
                flat += leaves(lt)
        else:
            tree[k] = tree_map(lambda a: a.detach().requires_grad_(), v)
            flat += leaves(tree[k])
    return tree, flat


def make_train_step(model, optimizer, *, clip_norm: float = 1.0):
    """One island's train step: (params, opt_state, batch, island=0) ->
    (params, opt_state, metrics {loss, grad_norm, xent, aux}), params and
    state updated in place.  With cfg.grad_accum > 1 the batch is split
    into that many microbatches: fp32 gradients accumulated as g / accum,
    the loss as loss / accum, the parts averaged, as the reference's scan.
    Its spans (`repro_torch.spans`, tagged with `island`): `step.forward`
    (the model and the loss) and `step.backward` (the gradients, remat's
    recompute and a microbatch's accumulation included) a microbatch,
    `step.optimizer` (norm, clip and update) once."""
    loss_fn = _loss_for(model)
    accum = max(1, model.cfg.grad_accum)

    def grads_of(tree, flat, batch, island, acc=None):
        """-> (loss, parts, grads); with `acc` (fp32 accumulators) the
        gradients / accum are added into it, which is returned."""
        with torch.enable_grad():
            with spans.span("step.forward", island=island):
                loss, parts = loss_fn(model, tree, batch)
            with spans.span("step.backward", island=island):
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
                if acc is not None:
                    for a, g in zip(acc, grads):
                        a.add_(g.float() / accum)
                    grads = acc
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            list(grads)

    def train_step(params, opt_state, batch, *, island: int = 0):
        tree, flat = grad_view(params)
        if accum == 1:
            loss, parts, grads = grads_of(tree, flat, batch, island)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            grads = [torch.zeros(f.shape, dtype=torch.float32,
                                 device=f.device) for f in flat]
            parts_all = []
            for j in range(accum):
                l, parts, grads = grads_of(
                    tree, flat, {k: v[j] for k, v in micro.items()}, island,
                    acc=grads)
                loss = loss + l / accum
                parts_all.append(parts)
            parts = {k: torch.stack([p[k] for p in parts_all]).mean()
                     for k in parts_all[0]}
        del tree, flat
        with spans.span("step.optimizer", island=island):
            grad_norm = global_norm(grads)
            state_pieces = [pieces(opt_state[m])
                            for m in moment_names(opt_state)]
            optimizer.step_(zip(pieces(params), grads, *state_pieces),
                            opt_state,
                            grad_scale=clip_scale(grad_norm, clip_norm))
        metrics = {"loss": loss.float(), "grad_norm": grad_norm, **parts}
        return params, opt_state, metrics

    return train_step


def make_fl_train_step(model, optimizer, n_islands: int, **kw):
    """The island-stacked step: a leading island axis on params, opt_state
    and batch, each island stepped on its own slices (in place), metrics
    stacked (P,).  The reference vmaps the step over the axis."""
    step = make_train_step(model, optimizer, **kw)
    if n_islands == 1:
        return step

    def fl_step(params, opt_state, batch):
        ms = [step(federated.island_slice(params, i),
                   federated.island_slice(opt_state, i),
                   {k: v[i] for k, v in batch.items()}, island=i)[2]
              for i in range(n_islands)]
        return params, opt_state, {k: torch.stack([m[k] for m in ms])
                                   for k in ms[0]}

    return fl_step


def make_fl_aggregate(compress=False, *, k_frac: float = 0.05,
                      impl: str = "auto"):
    """(stacked_params, mixing (P,P)) -> mixed stacked_params.  The paper's
    whole weight-exchange round.

    compress: False/"none" -> raw exchange (storage dtype on the wire);
    True/"q8", "topk", "q8_topk" (dashes accepted) -> the compressed delta
    exchange, signature (stacked, base, mixing), whose quant8 calls take
    `impl`."""
    mode = {False: "none", None: "none", True: "q8"}.get(compress, compress)
    mode = mode.replace("-", "_")
    if mode == "none":
        return federated.fl_aggregate
    return partial(federated.fl_aggregate_compressed, mode=mode,
                   k_frac=k_frac, impl=impl)


def make_prefill_step(model):
    """(params, batch) -> (greedy next token (B,), decode cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model.apply(params, batch, mode="prefill")
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return prefill_step


def make_chunk_prefill_step(model):
    """One chunk of chunked prefill: (params, batch, cache) -> (greedy
    next token (B,), cache).  `batch` carries the chunk's tokens, their
    absolute positions and last_index (the last valid row of a padded
    tail chunk); for the paged pool also block_tables.  `cache` is a
    contiguous spec'd cache (models/cache.py) or the pool {kp, vp},
    updated in place and consumed, as the JAX step donates it."""
    @torch.no_grad()
    def chunk_prefill_step(params, batch, cache):
        logits, cache = model.apply(params, batch, mode="chunk_prefill",
                                    cache=cache)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return chunk_prefill_step


def make_decode_step(model):
    """(params, batch, cache) -> (greedy next token (B,), cache).  The
    cache is updated in place and consumed, as the JAX loop donates it."""
    @torch.no_grad()
    def decode_step(params, batch, cache):
        logits, cache = model.apply(params, batch, mode="decode", cache=cache)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return decode_step
