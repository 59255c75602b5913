"""When the port's kernel builder rebuilds a library: ``_stale`` against
the source, the shared headers and the built library's times (no nvcc
needed)."""

import os

import pytest

from lasr_tpu_torch.ops import cuda_build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD", build)
    return csrc, build


def _touch(path, t):
    path.write_text("x")
    os.utime(path, (t, t))


@pytest.mark.parametrize("cu,cuh,so,stale", [
    (1, 2, 3, False),    # the library is newest
    (1, 3, 2, True),     # a shared header edited after the build
    (3, 1, 2, True),     # the source edited after the build
    (2, None, 3, False),  # no header at all
    (3, None, 2, True),
    (1, 2, None, True),  # never built
])
def test_stale_in_each_order(tree, cu, cuh, so, stale):
    csrc, build = tree
    base = 1_700_000_000
    _touch(csrc / "k.cu", base + cu)
    if cuh is not None:
        _touch(csrc / "shared.cuh", base + cuh)
    if so is not None:
        _touch(build / "libk.so", base + so)
    assert cuda_build._stale("k") is stale


def test_header_edit_makes_every_library_stale(tree):
    csrc, build = tree
    base = 1_700_000_000
    for name in ("a", "b"):
        _touch(csrc / f"{name}.cu", base)
        _touch(build / f"lib{name}.so", base + 2)
    assert not cuda_build._stale("a") and not cuda_build._stale("b")
    _touch(csrc / "mma.cuh", base + 3)
    assert cuda_build._stale("a") and cuda_build._stale("b")
