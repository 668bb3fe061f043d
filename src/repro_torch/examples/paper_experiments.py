"""Reproduce the paper's experiment suite (Figs. 12-18) end to end on the
port.

  PYTHONPATH=src python -m repro_torch.examples.paper_experiments
  PYTHONPATH=src python -m repro_torch.examples.paper_experiments fig18
  PYTHONPATH=src python -m repro_torch.examples.paper_experiments \
      fig18,fig12 --device cpu --seed 3

Prints curve CSV + the two headline metrics (worker selection vs
sequential ~34%, async vs sync ~64%)."""
import sys

from repro_torch.examples.paper import run as bench_run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    only = argv.pop(0) if argv and not argv[0].startswith("-") else \
        "fig12,fig13,fig14,fig15,fig16,fig17,fig18"
    return bench_run.main(["--only", only, *argv])


if __name__ == "__main__":
    main()
