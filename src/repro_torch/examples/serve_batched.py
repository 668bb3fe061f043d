"""Batched serving example: prefill a batch of prompts and decode greedily
with the KV/state-cache serve path (any arch the port serves), or
`--paged` through the block-table continuous-batching loop.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --paged
"""
import sys

from repro_torch.launch import serve


def main():
    argv = sys.argv[1:] or ["--arch", "falcon-mamba-7b", "--batch", "4",
                            "--prompt-len", "64", "--gen", "24"]
    serve.main(argv)


if __name__ == "__main__":
    main()
