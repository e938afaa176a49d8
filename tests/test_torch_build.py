"""The ctypes signatures in sdpcutsel_tpu_torch/_build.py match the C entry
points of csrc/*.cu.  nvcc exists only on the card's machine, so a
mismatch (which ctypes would pass on silently, cutting pointers or
misreading floats) is caught here from the sources."""

import ctypes
import os
import re

import pytest

from sdpcutsel_tpu_torch import _build

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _entry_points():
    out = {}
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = []
            for p in params.split(","):
                decl = p.strip().rsplit(" ", 1)[0]
                types.append(ctypes.c_void_p if "*" in p else _C_TYPES[decl])
            out[name] = types
    return out


def test_every_entry_point_has_a_matching_signature():
    entries = _entry_points()
    assert sorted(entries) == sorted(_build._SIGNATURES)
    for name, types in entries.items():
        assert _build._SIGNATURES[name] == types, name


def test_library_name_tracks_sources_and_build_dir_is_ignored():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path()
    repo = os.path.dirname(os.path.dirname(_build.CSRC_DIR))
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.relpath(_build.BUILD_DIR, repo).split(os.sep)[0] + "/" in ignored
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["pair_score.cu", "pair_packed.cu", "pdhg_block.cu",
                                  "fused_score.cu"])
def test_kernel_sources_name_the_tpu_kernel_they_replace(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        head = f.read(2000)
    assert "Replaces the Pallas TPU kernel sdpcutsel_tpu/" in head
    assert "What bounds it on the H100" in head and "Design:" in head
