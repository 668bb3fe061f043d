"""Registers, spills and shared memory of every hand-written kernel, as
ptxas reports them for Hopper.

Each kernel's sources are compiled with the port's own flags
(kernels/build.py) plus `-Xptxas -v` into a scratch library under the
system's temporary directory; one line per entry function follows.  It
needs nvcc (the machine with the card), not the card itself.

  PYTHONPATH=src python -m repro_torch.examples.kernel_resources
"""
from __future__ import annotations

import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace

from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
from repro_torch.kernels.fed_agg import kernel as fed_agg
from repro_torch.kernels.flash_attention import kernel as flash_attention
from repro_torch.kernels.linrec import kernel as linrec
from repro_torch.kernels.quant8 import kernel as quant8

KERNELS = {"fed_agg": fed_agg, "quant8": quant8,
           "flash_attention": flash_attention,
           # both head dims (the library a run builds holds one)
           "flash_attention_train": SimpleNamespace(
               SOURCES=flash_attention.TRAIN_SOURCES),
           "linrec": linrec}


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(name: str, sources: list[Path], tmp: Path) -> list[dict]:
    """One record per entry function of `sources`: registers, spill bytes
    (stores, loads), stack frame and static shared memory."""
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v",
           "-o", str(tmp / f"lib{name}.so"), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    recs, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": name, "entry": m.group(1), "registers": 0,
                   "spill_stores": 0, "spill_loads": 0, "stack": 0,
                   "smem": 0}
            recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    for rec, full in zip(recs, demangle([r["entry"] for r in recs])):
        rec["entry"] = full
    return recs


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod in KERNELS.items():
            for r in report(name, mod.SOURCES, Path(tmp)):
                print(f"{name}: {r['entry'][:100]}: {r['registers']} "
                      f"registers, spills {r['spill_stores']} / "
                      f"{r['spill_loads']} bytes (stores / loads), stack "
                      f"{r['stack']} bytes, static smem {r['smem']} bytes",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
