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


@pytest.mark.parametrize("mod", [flash_attention, linrec],
                         ids=["flash_attention", "linrec"])
def test_tma_kernels_hash_the_header_they_include(mod):
    """Each source that includes a csrc_common header lists it in its
    module's HEADERS, and the header exists."""
    text = mod.SOURCES[0].read_text()
    included = set(re.findall(r'#include "\.\./\.\./csrc_common/(\S+)"',
                              text))
    assert included == {h.name for h in mod.HEADERS} == {"tma.cuh"}
    for h in mod.HEADERS:
        assert h.is_file() and h.parent == build.COMMON
