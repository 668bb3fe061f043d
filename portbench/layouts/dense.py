"""The weight tree of a dense decoder-only LM, as the program takes it:
token embedding, untied output projection, a stack of L blocks (RMSNorm,
attention with optional QKV bias, RMSNorm, gated or plain MLP) and a final
norm.  Each leaf: (path, shape, init, scale) with init "normal" (times
`scale` = 1/sqrt(fan_in), 1 for the embedding), "ones" or "zeros".  A
family's layout also gives its training FLOPs a token
(`train_flops_per_token`), which `mfu.train` divides by."""
from __future__ import annotations

import math

from portbench import roofline


def leaves(arch: dict) -> list[tuple[str, tuple, str, float]]:
    d, L, V = arch["d_model"], arch["num_layers"], arch["vocab_size"]
    H, Hkv, D, f = (arch["num_heads"], arch["num_kv_heads"],
                    arch["head_dim"], arch["d_ff"])
    def s(n):
        return 1 / math.sqrt(n)

    out = [("embed/tok", (V, d), "normal", 1.0)]
    if not arch.get("tie_embeddings", False):
        out.append(("embed/unembed", (d, V), "normal", s(d)))
    out += [("final_norm/scale", (d,), "ones", 1.0),
            ("layers/attn/wq", (L, d, H, D), "normal", s(d)),
            ("layers/attn/wk", (L, d, Hkv, D), "normal", s(d)),
            ("layers/attn/wv", (L, d, Hkv, D), "normal", s(d)),
            ("layers/attn/wo", (L, H, D, d), "normal", s(H * D))]
    if arch.get("qkv_bias", False):
        out += [("layers/attn/bq", (L, H, D), "zeros", 1.0),
                ("layers/attn/bk", (L, Hkv, D), "zeros", 1.0),
                ("layers/attn/bv", (L, Hkv, D), "zeros", 1.0)]
    out += [("layers/ln1/scale", (L, d), "ones", 1.0),
            ("layers/ln2/scale", (L, d), "ones", 1.0),
            ("layers/mlp/w_up", (L, d, f), "normal", s(d)),
            ("layers/mlp/w_down", (L, f, d), "normal", s(f))]
    if arch["act"] in ("silu", "gelu"):
        out.append(("layers/mlp/w_gate", (L, d, f), "normal", s(d)))
    return sorted(out)


def n_params(arch: dict, *, input_embedding: bool = True) -> int:
    n = sum(math.prod(shape) for path, shape, _, _ in leaves(arch)
            if input_embedding or path != "embed/tok")
    return int(n)


def train_flops_per_token(arch: dict, seq: int) -> float:
    """Every product of a dense block is active for every token: N is the
    whole tree but the input embedding table, the attention width H D."""
    return roofline.train_flops_per_token(
        n_params(arch, input_embedding=False), arch["num_layers"],
        arch["num_heads"] * arch["head_dim"], seq)
