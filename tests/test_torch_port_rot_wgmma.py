"""K1 / K2's bf16 wide forms on Hopper's wgmma and TMA
(``csrc/rot_attention_sm90.cu``, ``csrc/rot_attention_bwd_sm90.cu``) on
the CPU: what picks them and what they refuse before a launch.

  - ``rot_kernel_form`` as a pure function: the recipe's shapes keep the
    narrow form, the 1B config's (dk = 80, M = 1280) take the wgmma form
    in bf16 and the older wide form in f32, and a bf16 shape that TMA cannot
    describe (a row not a multiple of 16 bytes, or a base off a 16-byte
    boundary) keeps the wide form.
  - ``rot_attention_forward`` / ``rot_attention_backward`` route a bf16
    1B-shaped call on a CUDA tensor (a CPU tensor routed as CUDA) to the
    wgmma entry points; the wgmma wrappers raise ``ValueError`` for f32,
    for widths TMA cannot describe, for misaligned tensors and for CPU
    tensors (the routed calls run the plain version there), before any
    build or launch.

The plain K1 / K2 (dz rounded to bf16 before its products, as the Pallas
kernel rounds it) are held against ``lasr_tpu``'s Pallas kernels at wide
heads in ``tests/test_torch_port_wide_heads.py``, and the kernels against
those plain versions on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` stretch_1b (a)).
"""

from types import SimpleNamespace

import pytest
import torch

from lasr_tpu_torch.ops import rot_attention as rot

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dk,M,dtype,aligned,backward,form", [
    (40, 320, BF, True, False, "narrow"),     # the recipe, served
    (40, 320, BF, True, True, "narrow"),      # the recipe, trained
    (80, 1280, BF, True, False, "wgmma"),     # the 1B config in bf16
    (80, 1280, BF, True, True, "wgmma"),
    (80, 1280, F32, True, False, "wide"),     # the 1B config in f32
    (80, 1280, F32, True, True, "wide"),
    (77, 301, BF, True, False, "wide"),       # rows of 154 / 602 bytes
    (80, 1284, BF, True, True, "wide"),       # u's rows of 2,568 bytes
    (80, 1280, BF, False, False, "wide"),     # a base off 16 bytes
    (40, 2048, BF, True, True, "wgmma"),      # dk <= 64 too wide a block
])
def test_rot_kernel_form(dk, M, dtype, aligned, backward, form):
    assert rot.rot_kernel_form(dk, M, dtype, backward, aligned) == form


def _args(BH, T, dk, M, dtype=BF, offset=0):
    """Zero inputs; ``offset`` elements shift u's start off its storage's
    (a contiguous tensor whose base is not 16-byte aligned)."""
    z = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    u = torch.zeros(BH * T * M + offset, dtype=dtype)[offset:].view(BH, T, M)
    kv = torch.full((BH,), T, dtype=torch.int32)
    return (z(BH, T, dk), u, z(BH, T, dk), z(BH, T, dk), z(T, M), kv)


def _bwd_extra(BH, T, dk, dtype=BF):
    return (torch.zeros(BH, T, dk, dtype=dtype), torch.zeros(BH, T),
            torch.zeros(BH, T, dk, dtype=dtype))


def test_routing_reaches_the_wgmma_entry_points(monkeypatch):
    """On a CUDA tensor (a CPU one routed as CUDA) a bf16 call at the 1B
    widths binds the wgmma entry points, a misaligned one the older wide
    ones, an f32 one too; the shape checks come first."""
    bound = []

    class Bound(Exception):
        pass

    def bind(source, symbol, n_ptr, n_int):
        bound.append((source, symbol, n_ptr, n_int))
        raise Bound
    monkeypatch.setattr(rot, "_device_path", lambda name, device: True)
    monkeypatch.setattr(rot, "_smem_limit", lambda device: 232448)
    monkeypatch.setattr(rot, "_bind", bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    BH, T, dk, M = 2, 5, 80, 1280
    for offset, dtype in ((0, BF), (1, BF), (0, F32)):
        args = _args(BH, T, dk, M, dtype, offset)
        with pytest.raises(Bound):
            rot.rot_attention_forward(*args)
        with pytest.raises(Bound):
            rot.rot_attention_backward(*args, *_bwd_extra(BH, T, dk, dtype))
    assert bound == [
        ("rot_attention_sm90", "lasr_rot_attention_fwd_wgmma", 8, 4),
        ("rot_attention_bwd_sm90", "lasr_rot_attention_bwd_wgmma", 15, 4),
        ("rot_attention", "lasr_rot_attention_fwd_wide", 8, 5),
        ("rot_attention_bwd", "lasr_rot_attention_bwd_wide", 15, 5),
        ("rot_attention", "lasr_rot_attention_fwd_wide", 8, 5),
        ("rot_attention_bwd", "lasr_rot_attention_bwd_wide", 15, 5)]


@pytest.mark.parametrize("case,match", [
    (dict(dtype=F32), "bfloat16"),
    (dict(dk=77, M=301), "multiples of 8"),
    (dict(dk=136, M=320), "dk <= 128"),
    (dict(offset=1), "16-byte"),
    (dict(), "CUDA tensors"),
])
@pytest.mark.parametrize("backward", [False, True])
def test_wgmma_wrappers_refuse_before_launch(case, match, backward,
                                            monkeypatch):
    """Raised before anything is built or launched, on CPU tensors and on
    CPU tensors routed as CUDA; the launch counts stay."""
    monkeypatch.setattr(rot, "_bind", lambda *a: pytest.fail("launched"))
    kw = dict(dict(dk=80, M=1280, dtype=BF, offset=0), **case)
    BH, T = 2, 5
    args = _args(BH, T, kw["dk"], kw["M"], kw["dtype"], kw["offset"])
    fn = rot.rot_attention_backward_wgmma if backward \
        else rot.rot_attention_forward_wgmma
    extra = _bwd_extra(BH, T, kw["dk"], kw["dtype"]) if backward else ()
    before = fn.launches
    # a CPU tensor that passes the other checks is refused as such
    for device_path in (False, True) if case else (False,):
        monkeypatch.setattr(rot, "_device_path",
                            lambda name, device, on=device_path: on)
        with pytest.raises(ValueError, match=match):
            fn(*args, *extra)
    assert fn.launches == before
