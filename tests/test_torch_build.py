"""The kernel build's library names (kernels/build.py), on the CPU: a
library is named by a hash of its sources and of the shared headers they
include, so an edit to either is never served from a stale library."""
from __future__ import annotations

import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as flash_attention
from repro_torch.kernels.linrec import kernel as linrec


def test_library_name_follows_sources_and_headers(tmp_path):
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    hdr.write_text("// one\n")
    first = build.library_path("k", [src], [hdr])
    assert build.library_path("k", [src], [hdr]) == first
    hdr.write_text("// two\n")
    second = build.library_path("k", [src], [hdr])
    assert second != first
    src.write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k", [src], [hdr]) not in (first, second)
    assert first.parent == build.BUILD_DIR


def _included(path, seen):
    """The headers `path` includes by a quoted relative path, and theirs
    in turn, resolved against the including file."""
    for name in re.findall(r'#include "(\S+)"', path.read_text()):
        h = (path.parent / name).resolve()
        if h not in seen:
            seen.add(h)
            _included(h, seen)
    return seen


@pytest.mark.parametrize("mod", [flash_attention, linrec],
                         ids=["flash_attention", "linrec"])
def test_tma_kernels_hash_the_header_they_include(mod):
    """Every header a library's sources include, directly or through
    another header, is in its module's HEADERS (which the library's name
    hashes) and exists; the shared csrc_common/tma.cuh among them, and no
    header listed that none includes."""
    for sources in (mod.SOURCES, getattr(mod, "TRAIN_SOURCES", [])):
        for src in sources:
            included = _included(src, set())
            assert included == {h.resolve() for h in mod.HEADERS}
    assert build.COMMON / "tma.cuh" in mod.HEADERS
    for h in mod.HEADERS:
        assert h.is_file()
