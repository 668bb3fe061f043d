"""Device selection for the port's entry points.

Entry points default to CUDA.  A CUDA request on a machine without a card
raises: the port never falls back to the CPU on its own.  Only an explicit
``device="cpu"`` (the tests) runs on the host.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the host")
        # fp32 convolutions would otherwise run in TF32 through cuDNN (about
        # three decimal digits); the port holds fp32 parity with the JAX
        # reference, so both TF32 switches stay off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # A seeded simulation replays exactly, as the reference's does:
        # cuDNN picks deterministic algorithms and does not autotune.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_label(device) -> str:
    """The card's `name, power limit` as nvidia-smi prints them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
