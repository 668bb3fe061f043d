"""Step factories, port of `repro.launch.steps`: so far only the island
exchange (`make_fl_aggregate`).  The train and serve steps come with the LM
stack."""
from __future__ import annotations

from functools import partial

from repro_torch.core import federated


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
