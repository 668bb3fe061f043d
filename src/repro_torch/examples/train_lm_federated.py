"""End-to-end example: federated pretraining of a ~100M-param LM, port of
the reference's examples/train_lm_federated.py.

Two FL islands train a granite-family decoder on disjoint token streams,
exchanging weights every 5 steps through the mixing exchange, with
checkpoints and straggler-aware selection: `launch/train.py`'s loop on a
custom config, handed to its `main(cfg=...)`.

Defaults are small (~10M params, 60 steps); --hundred-m runs the ~100M /
300-step model (the same code path, longer).

  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated
  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
      --device cpu --steps 10
  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
      --hundred-m
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "flight_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.hundred_m:
        # ~100M decoder: 12L x 768 x 12H, 32k vocab
        cfg = dataclasses.replace(
            get_smoke_config("granite-20b"), name="custom-lm",
            num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=3072, vocab_size=32_768, remat=True)
        steps = args.steps or 300
        batch, seq = 8, 256
    else:
        cfg = dataclasses.replace(
            get_smoke_config("granite-20b"), name="custom-lm",
            num_layers=6, d_model=256, num_heads=8, num_kv_heads=2,
            head_dim=32, d_ff=1024, vocab_size=8_192)
        steps = args.steps or 60
        batch, seq = 8, 128

    argv = ["--arch", "custom-lm", "--smoke", "--steps", str(steps),
            "--islands", "2", "--local-steps", "5",
            "--batch", str(batch), "--seq", str(seq),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
            "--device", args.device]
    if args.resume:
        argv.append("--resume")
    return train.main(argv, cfg=cfg)


if __name__ == "__main__":
    main()
