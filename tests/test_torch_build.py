"""The kernel build's cache key and the bf16 flash head-dim rule, on the
CPU (no nvcc needed).

Each library's file name carries a hash of its source, of every header
under ``csrc/`` and of the flags (``_build.library_path``), so an edit to
any header, a new header or a renamed one must change every library's
path: a stale library is then never loaded."""

import shutil

import pytest
import torch

from mpi_operator_tpu_torch.ops import _build
from mpi_operator_tpu_torch.ops import _common
from mpi_operator_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.kernel

HEADERS = sorted(p.name for p in _build.CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads in place of the real
    one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in _build.KERNELS}


def test_the_key_reads_the_sources_not_their_directory(csrc, monkeypatch):
    copied = _paths()
    monkeypatch.setattr(_build, "CSRC", _build._PKG / "csrc")
    assert _paths() == copied
    assert [h.name for h in _build.headers()] == HEADERS


@pytest.mark.parametrize("header", HEADERS)
def test_editing_any_header_rebuilds_every_library(csrc, header):
    before = _paths()
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)


def test_a_new_header_rebuilds_every_library(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)


def test_a_renamed_header_rebuilds_every_library(csrc):
    before = _paths()
    (csrc / HEADERS[0]).rename(csrc / ("renamed_" + HEADERS[0]))
    after = _paths()
    assert all(after[name] != before[name] for name in before)


def test_editing_a_source_rebuilds_only_its_library(csrc):
    before = _paths()
    source = csrc / _build.KERNELS["flash_fwd"][0]
    source.write_text(source.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_fwd"] != before["flash_fwd"]
    assert all(after[n] == before[n] for n in before if n != "flash_fwd")


@pytest.mark.parametrize("head_dim,width", [
    (8, 64), (16, 64), (32, 64), (64, 64),
    (72, 128), (80, 128), (96, 128), (128, 128),
])
def test_bf16_head_dims_run_on_the_next_instantiated_width(head_dim, width):
    assert _common.flash_tc_head_dim(head_dim) == width


@pytest.mark.parametrize("head_dim", [0, 12, 20, 100, 130, 136, 256])
def test_bf16_head_dims_the_bodies_cannot_take_raise(head_dim):
    with pytest.raises(ValueError, match="bf16 flash kernels take head_dim"):
        _common.flash_tc_head_dim(head_dim)


def test_operands_are_made_16_byte_aligned_only_when_they_are_not():
    base = torch.arange(130, dtype=torch.bfloat16)
    aligned = base[:128].reshape(2, 64)
    assert tattn._dense(aligned) is aligned
    shifted = base[1:129].reshape(2, 64)  # 2 bytes past an aligned start
    fixed = tattn._dense(shifted)
    assert fixed.data_ptr() % 16 == 0 and fixed.is_contiguous()
    assert torch.equal(fixed, shifted)
    strided = base[:128].reshape(64, 2).t()
    assert torch.equal(tattn._dense(strided), strided)
    assert tattn._dense(strided).is_contiguous()
