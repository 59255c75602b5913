"""The port's CUDA kernels and kernel paths on the card.

Marked ``cuda``: run with ``python -m pytest -m cuda
tests/test_torch_port_cuda.py`` on a machine with an NVIDIA Hopper GPU.
Whether a card is present is decided inside each test (never while the
module is imported), so every pytest-xdist worker collects the same
tests; without a card they skip.

Tolerances: 1e-4 max-abs in f32 (summation order only); 2e-2 in bf16
against the plain version run in f32 on the same bf16 inputs (P is
rounded to bf16 before P@V, as in the TPU kernels).
"""

import numpy as np
import pytest
import torch

from lasr_tpu_torch.ops.rel_attention import (rel_attention_forward,
                                              rel_attention_reference)
from lasr_tpu_torch.ops.rot_attention import (rot_attention_forward,
                                              rot_attention_reference)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(which, BH, H, T, dk, M, lens, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def f(*s, sc=1.0):
        return torch.from_numpy((rng.standard_normal(s) * sc).astype(
            np.float32)).to(dev, dtype)
    kv = torch.tensor(np.repeat(lens, H), dtype=torch.int32, device=dev)
    if which == "rot":
        return (f(BH, T, dk), f(BH, T, M, sc=0.3), f(BH, T, dk), f(BH, T, dk),
                f(T, M, sc=0.3), kv)
    return (f(BH, T, dk), f(BH, T, dk), f(BH, T, dk), f(BH, T, dk),
            f(H, 2 * T - 1, dk), kv)


@pytest.mark.parametrize("which", ["rot", "rel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,dk,M,lens", [
    (248, 40, 320, [248, 200, 131, 1]),     # the served shape, ragged
    (37, 64, 64, [37, 0, 5, 33]),           # an empty row, dk = 64
    (70, 16, 48, [64, 65, 1, 70]),          # tile edges
])
def test_kernel_matches_plain(which, dtype, T, dk, M, lens):
    dev = _card()
    H = 2
    BH = len(lens) * H
    fwd, ref = ((rot_attention_forward, rot_attention_reference)
                if which == "rot" else
                (rel_attention_forward, rel_attention_reference))
    args = _inputs(which, BH, H, T, dk, M, lens, dtype, dev)
    before = fwd.launches
    out, lse = fwd(*args)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    want, want_lse = ref(*[a.float() if a.is_floating_point() else a
                           for a in args])
    assert out.dtype == dtype and out.is_cuda
    assert float((out.float() - want).abs().max()) <= TOL[dtype]
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    assert float((lse[finite] - want_lse[finite]).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("flags", [{"encoder_rot_fold_pallas": True},
                                   {"encoder_use_pallas_attention": True}])
def test_model_kernel_path_matches_plain_path(flags):
    dev = _card()
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    kw = dict(idim=80, odim=50, encoder_attention_dim=64,
              encoder_attention_heads=4, encoder_linear_units=128,
              encoder_num_blocks=2, decoder_attention_dim=64,
              decoder_attention_heads=4, decoder_linear_units=128,
              decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
              encoder_selfattention_layer_type="rel_selfattn")
    torch.manual_seed(0)
    plain = E2E_Conformer_CTC(**kw, device=dev)
    fast = E2E_Conformer_CTC(**kw, **flags, device=dev)
    fast.load_state_dict(plain.state_dict())
    x = torch.randn(3, 301, 80, device=dev)
    xlen = torch.tensor([301, 250, 120], device=dev)
    counters = (rot_attention_forward, rel_attention_forward)
    before = [c.launches for c in counters]
    with torch.no_grad():
        hs, hs_len = fast.encode(x, xlen, solo_pad=True)
        want, want_len = plain.encode(x, xlen, solo_pad=True)
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([2, 0] if "encoder_rot_fold_pallas" in flags
                        else [0, 2])
    assert torch.equal(hs_len, want_len)
    assert float((hs - want).abs().max()) <= 1e-3
