"""The port's kernel build cache (``incubator_mxnet_torch/ops/_cuda.py``)
is keyed on everything that goes into a compile: the source, every header
it includes from its directory, the flags and the compiler's version
string.  The key is computed on the CPU, with no nvcc, over a temporary
source directory."""
import pytest

from incubator_mxnet_torch.ops import _cuda

FLAGS = ("-O3", "-arch=sm_90a")
NVCC = "Cuda compilation tools, release 12.4, V12.4.131"


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include <cuda.h>\n#include "shared.cuh"\nint k;\n')
    (tmp_path / "shared.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint s;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "unrelated.cuh").write_text("int u;\n")
    return tmp_path


def test_includes_follow_quoted_headers(csrc):
    assert [p.name for p in _cuda.includes(csrc / "kernel.cu")] == ["shared.cuh", "inner.cuh"]


@pytest.mark.parametrize("edit", ["kernel.cu", "shared.cuh", "inner.cuh"])
def test_digest_changes_with_the_source_and_every_included_header(csrc, edit):
    before = _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC)
    assert _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC) == before
    (csrc / edit).write_text((csrc / edit).read_text() + "int edited;\n")
    assert _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC) != before


def test_digest_ignores_headers_the_source_does_not_include(csrc):
    before = _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC)
    (csrc / "unrelated.cuh").write_text("int changed;\n")
    assert _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC) == before


def test_digest_changes_with_the_compiler_and_the_flags(csrc):
    before = _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC)
    assert _cuda.source_digest(csrc / "kernel.cu", FLAGS, NVCC.replace("12.4", "12.6")) != before
    assert _cuda.source_digest(csrc / "kernel.cu", FLAGS + ("-G",), NVCC) != before


def test_the_port_sources_name_their_shared_header():
    names = {name: [p.name for p in _cuda.includes(_cuda.CSRC / f"{name}.cu")]
             for name in ("flash_fwd", "flash_bwd", "bn")}
    assert names == {"flash_fwd": ["flash_tma.cuh"], "flash_bwd": ["flash_tma.cuh"], "bn": []}
