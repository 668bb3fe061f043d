"""Build a kernel's CUDA sources into a shared library and load it.

Sources under `<kernel>/csrc/` have a plain C interface; nvcc compiles them
for Hopper (`sm_90a`) into `kernels/_build/` (listed in .gitignore), named
by a hash of the sources, the headers they include from `csrc_common/`
and the flags, so an edited source or header is never served from a stale
library.  The build happens at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
COMMON = Path(__file__).resolve().parent / "csrc_common"   # shared headers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    default = cuda_home / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found (PATH or {default}): the port's "
                       "CUDA kernels are built on a machine with the CUDA "
                       "toolkit and the card")


def library_path(name: str, sources: list[Path],
                 headers: list[Path] = (), flags: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: list[Path],
                  headers: list[Path] = (), flags: tuple = ()) -> Path:
    """Compile `sources` (with the extra nvcc `flags`, such as a -D that
    picks what the source instantiates) unless the library for their exact
    content, that of the `headers` they include and the flags exists."""
    out = library_path(name, sources, headers, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def load_library(name: str, sources: list[Path],
                 headers: list[Path] = (), flags: tuple = ()) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources, headers, flags)))
