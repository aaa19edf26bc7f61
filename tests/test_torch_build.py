"""The kernels' build cache key (``horovod_tpu_torch.ops._build``): the
library path changes whenever a byte of the source, of a header it
includes, or of the compiler flags changes. No ``nvcc`` is needed."""

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    return tmp_path


def test_inputs_follow_quoted_includes(csrc):
    assert [p.name for p in _build.inputs("k")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_target_changes_with_every_input(csrc, edited):
    before = _build.target("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build.target("k")
    assert after != before
    assert after.name.startswith("libk_") and after.suffix == ".so"


def test_target_ignores_files_not_included(csrc):
    before = _build.target("k")
    (csrc / "other.cuh").write_text("// edited\n")
    assert _build.target("k") == before


def test_target_changes_with_the_flags(csrc, monkeypatch):
    before = _build.target("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.target("k") != before


def test_flash_source_hashes_its_hopper_header():
    names = [p.name for p in _build.inputs("flash_attention")]
    assert names == ["flash_attention.cu", "sm90.cuh"]
