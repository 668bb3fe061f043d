"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one H100.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

and prints one JSON line: `correct`, `attempted`, `failed`, `metrics`,
`device` (and with `--trace 1` a `breakdown`), then the numbers compared
with their limits.  `BENCHMARK.json` at the checkout's root names the
cells; everything that belongs to one thing sits in a file of its own,
found by its name:

    configs/<config>.json     a model configuration as it is run: `as_run`
                              the program's ModelConfig, `harness` what
                              only the reference reads (a norm epsilon,
                              each auxiliary loss term's coefficient)
    traffic/<traffic>.json    a traffic mix: its driver and parameters
    limits/<workload>.json    the limits of a cell's output comparison
    metrics/<metric>.py       a per-layer metric's reader (`read(run)`)
    drivers/<driver>.py       what drives the program for a kind of mix
    layouts/<family>.py       a model family's weight tree and training
                              FLOPs a token
    reference/<family>.py     the plain float32 reference of a family,
                              with its auxiliary loss terms if it has any

Nothing here imports `jax` or the JAX package; `reference/` imports
nothing of `repro_torch`.
"""
