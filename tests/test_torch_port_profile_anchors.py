"""The by-part profile scripts' text edits still match the kernels.

Each ``profile_torch_*.py`` that times a kernel by part builds variants
from text edits of a copy of ``lasr_tpu_torch/csrc`` (``EDITS``: file,
anchor, replacement).  A kernel edit that drops an anchor would stop the
script only on the card; here every variant is written into a temporary
directory (no nvcc needed) and each of its anchors must be found and
replaced."""

import importlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("profile_torch_rot_bwd", "profile_torch_rot_fwd",
           "profile_torch_rel_bwd", "profile_torch_rel_fwd")


def _script(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(name)


def _cases():
    # the EDITS tables are plain module constants: reading them imports
    # numpy only (torch is imported inside the scripts' main)
    return [(name, variant) for name in SCRIPTS
            for variant in _script(name).EDITS]


@pytest.mark.parametrize("script,variant", _cases())
def test_variant_anchors_match_the_kernel(script, variant, tmp_path):
    from lasr_tpu_torch.ops import cuda_build
    mod = _script(script)
    edits = mod.EDITS[variant]
    assert edits, variant
    kernel = mod.KERNEL
    write = _script("profile_torch_rot_bwd").write_variant
    path = write(str(cuda_build.CSRC), str(tmp_path), variant, kernel,
                 mod.EDITS)
    assert os.path.basename(path) == kernel
    out_dir = os.path.dirname(path)
    for fname, anchor, new in edits:
        original = (cuda_build.CSRC / fname).read_text()
        assert anchor in original, (fname, anchor)
        edited = open(os.path.join(out_dir, fname)).read()
        assert new in edited and edited != original, (fname, anchor)


@pytest.mark.parametrize("script", SCRIPTS)
def test_base_is_the_committed_source(script, tmp_path):
    from lasr_tpu_torch.ops import cuda_build
    mod = _script(script)
    write = _script("profile_torch_rot_bwd").write_variant
    path = write(str(cuda_build.CSRC), str(tmp_path), "base", mod.KERNEL,
                 mod.EDITS)
    assert open(path).read() == (cuda_build.CSRC / mod.KERNEL).read_text()
