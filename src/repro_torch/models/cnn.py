"""Small CNN / MLP classifiers -- the paper's own Tier-A workload
(MNIST / CIFAR-10 style federated training on heterogeneous workers).

Params keep the reference's layouts (`repro.models.cnn`): conv weights
HWIO, images NHWC, and `fc_w`'s rows in (h, w, c) flatten order.  The
convolutions run in PyTorch's NCHW/OIHW convention on a permuted VIEW of
the NHWC input (channels_last memory, which cuDNN takes as it is), and the
activations are permuted back to NHWC before the flatten.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import pdef


def cnn_defs(cfg):
    chans = cfg.cnn_channels or (16, 32)
    c_in = cfg.img_c
    defs = {}
    for i, c_out in enumerate(chans):
        defs[f"conv{i}_w"] = pdef((3, 3, c_in, c_out), (None, None, None, None),
                                  dtype=torch.float32, fan_in_axes=(0, 1, 2))
        defs[f"conv{i}_b"] = pdef((c_out,), (None,), dtype=torch.float32,
                                  init="zeros")
        c_in = c_out
    hw = cfg.img_hw // (2 ** len(chans))
    flat = hw * hw * c_in
    defs["fc_w"] = pdef((flat, cfg.n_classes), (None, None),
                        dtype=torch.float32, fan_in_axes=(0,))
    defs["fc_b"] = pdef((cfg.n_classes,), (None,), dtype=torch.float32,
                        init="zeros")
    return defs


def cnn_apply(params, cfg, batch_inputs, *, mode="train", cache=None):
    """batch_inputs: {"images": (B,H,W,C) float32}. Returns (logits, 0.0)."""
    x = batch_inputs["images"].float().permute(0, 3, 1, 2)      # NCHW view
    chans = cfg.cnn_channels or (16, 32)
    for i in range(len(chans)):
        w = params[f"conv{i}_w"].permute(3, 2, 0, 1)            # HWIO->OIHW
        x = F.conv2d(x, w, params[f"conv{i}_b"], padding=1)     # SAME, 3x3
        x = F.max_pool2d(F.relu(x), 2)                          # 2x2 VALID
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)           # NHWC flatten
    logits = x @ params["fc_w"] + params["fc_b"]
    return logits, 0.0


def mlp_classifier_defs(cfg):
    d_in = cfg.img_hw * cfg.img_hw * cfg.img_c
    h = cfg.d_model or 128
    return {
        "w1": pdef((d_in, h), (None, None), dtype=torch.float32,
                   fan_in_axes=(0,)),
        "b1": pdef((h,), (None,), dtype=torch.float32, init="zeros"),
        "w2": pdef((h, cfg.n_classes), (None, None), dtype=torch.float32,
                   fan_in_axes=(0,)),
        "b2": pdef((cfg.n_classes,), (None,), dtype=torch.float32,
                   init="zeros"),
    }


def mlp_classifier_apply(params, cfg, batch_inputs, *, mode="train",
                         cache=None):
    x = batch_inputs["images"].float()
    x = x.reshape(x.shape[0], -1)
    x = F.relu(x @ params["w1"] + params["b1"])
    return x @ params["w2"] + params["b2"], 0.0
