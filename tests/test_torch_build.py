"""The kernel build's cache key, the bf16 flash head-dim rule and the
head-dim limit the sources and the wrappers share, on the CPU (no nvcc
needed).

Each library's file name carries a hash of its source, of every header
under ``csrc/`` and of the flags (``_build.library_path``), so an edit to
any header, a new header or a renamed one must change every library's
path: a stale library is then never loaded."""

import re
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


# A head dim that is not a multiple of 8 (12, 20, 100, 300) runs padded
# with zero columns to the next multiple (flash_padded_head_dim), on the
# body that covers it; 129..256 run on the 256 body, and past 256 each
# block of the head's cluster runs the 256 body.
@pytest.mark.parametrize("head_dim,width", [
    (8, 64), (12, 64), (16, 64), (20, 64), (32, 64), (64, 64),
    (72, 128), (80, 128), (96, 128), (100, 128), (128, 128),
    (130, 256), (136, 256), (256, 256),
    (300, 256), (512, 256), (576, 256), (1024, 256),
])
def test_bf16_head_dims_run_on_the_next_instantiated_width(head_dim, width):
    assert _common.flash_tc_head_dim(head_dim) == width
    assert _common.flash_tc_head_dim(
        _common.flash_padded_head_dim(head_dim)) == width


@pytest.mark.parametrize("head_dim", [0, 1025, 1032, 2048])
def test_bf16_head_dims_the_bodies_cannot_take_raise(head_dim):
    with pytest.raises(ValueError, match="flash kernels take head_dim"):
        _common.flash_tc_head_dim(head_dim)


def _source_constant(name: str) -> int:
    """``constexpr int <name> = <n>;`` in csrc/flash_common.cuh."""
    text = (_build.CSRC / "flash_common.cuh").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


def test_the_head_dim_limit_agrees_across_sources_and_wrappers():
    """The widest head dim is stated once in each of csrc/flash_common.cuh
    (MAX_D), the wrappers (_KERNEL_MAX_D) and the split plan
    (FLASH_MAX_HEAD_DIM: 1024 taken, 1025 refused), as is the split width
    (SPLIT_W, FLASH_SPLIT_WIDTH); the cluster of the widest head is at
    most 4 blocks, and dk/dv's cluster of twice that at most 8, the
    portable limit."""
    max_d = _source_constant("MAX_D")
    assert max_d == tattn._KERNEL_MAX_D == _common.FLASH_MAX_HEAD_DIM
    assert _source_constant("SPLIT_W") == _common.FLASH_SPLIT_WIDTH
    n, width = _common.flash_split_plan(max_d)
    assert n * width == max_d and n <= 4 and 2 * n <= 8
    with pytest.raises(ValueError, match=str(max_d)):
        _common.flash_split_plan(max_d + 1)


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
