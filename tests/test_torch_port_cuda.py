"""The port's CUDA kernels and kernel paths on the card.

Marked ``cuda``: run with ``python -m pytest -m cuda
tests/test_torch_port_cuda.py`` on a machine with an NVIDIA Hopper GPU.
Whether a card is present is decided inside each test (never while the
module is imported), so every pytest-xdist worker collects the same
tests; without a card they skip.

Tolerances: 1e-4 max-abs in f32 (summation order only); 2e-2 in bf16
against the plain version run in f32 on the same bf16 inputs (P is
rounded to bf16 before P@V, as in the TPU kernels).  Backward kernels:
the max error of each gradient relative to the largest magnitude of the
plain gradient, within the same 1e-4 / 2e-2.
"""

import numpy as np
import pytest
import torch

from lasr_tpu_torch.ops.rel_attention import (
    rel_attention_backward, rel_attention_backward_reference,
    rel_attention_forward, rel_attention_reference)
from lasr_tpu_torch.ops.rot_attention import (
    rot_attention_backward, rot_attention_backward_reference,
    rot_attention_backward_wgmma, rot_attention_forward,
    rot_attention_forward_wgmma, rot_attention_reference)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# parameters whose true gradient is 0: the softmax removes q·b_k, the
# train-mode BatchNorm removes the depthwise conv's bias
ZERO_GRADIENT_LEAVES = ("linear_k.bias", "depthwise_conv.bias")


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


SHAPES = [
    (248, 40, 320, [248, 200, 131, 1]),     # the served shape, ragged
    (37, 64, 64, [37, 0, 5, 33]),           # an empty row, dk = 64
    (70, 16, 48, [64, 65, 1, 70]),          # tile edges
    (45, 12, 20, [45, 17]),                 # dk, M not multiples of 16
    (388, 40, 320, [388, 291, 97, 1]),      # training width, ragged T
]
# wide heads (64 < dk <= 128): the 1B config's dk = 80 at its training T;
# K1 / K2 at the model width M = 16 dk (their wide form)
WIDE_SHAPES = [
    (388, 80, 1280, [388, 291, 97, 1]),
    (37, 128, 256, [37, 0, 5, 33]),
    (70, 96, 1536, [64, 65, 1, 70]),
]
CASES = ([(w,) + s for w in ("rot", "rel") for s in SHAPES]
         + [(w,) + s for w in ("rel", "rot") for s in WIDE_SHAPES])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which,T,dk,M,lens", CASES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which,T,dk,M,lens", CASES)
def test_backward_kernel_matches_plain(which, dtype, T, dk, M, lens):
    dev = _card()
    H = 2
    BH = len(lens) * H
    fwd, bwd, ref = ((rot_attention_forward, rot_attention_backward,
                      rot_attention_backward_reference) if which == "rot" else
                     (rel_attention_forward, rel_attention_backward,
                      rel_attention_backward_reference))
    args = _inputs(which, BH, H, T, dk, M, lens, dtype, dev)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BH, T, dk)).astype(np.float32)).to(dev, dtype)
    out, lse = fwd(*args)
    before = bwd.launches
    grads = bwd(*args, out, lse, dout)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = ref(*f32, out.float(), lse, dout.float())
    empty = torch.from_numpy(np.repeat(np.asarray(lens) == 0, H)).to(dev)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        err = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert err <= TOL[dtype], (i, err)
        if i < 4:   # per-bh gradients: rows of an empty row are exact zeros
            assert not bool(g[empty].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,dk,M,lens", [
    (29, 9, 21, [29, 11]),      # odd widths: 4-byte copies / registers
    (70, 40, 600, [70, 33]),    # E = 640: one key-tile buffer
    (45, 64, 1280, [45, 1, 17]),  # dk <= 64 too wide for a block: wide form
    (29, 77, 301, [29, 11]),    # wide form, odd widths
])
def test_rot_forward_kernel_copy_routes(dtype, T, dk, M, lens):
    """K1's other routes into shared memory, against the plain forward."""
    dev = _card()
    H = 2
    args = _inputs("rot", len(lens) * H, H, T, dk, M, lens, dtype, dev)
    out, lse = rot_attention_forward(*args)
    torch.cuda.synchronize()
    want, want_lse = rot_attention_reference(
        *[a.float() if a.is_floating_point() else a for a in args])
    assert out.dtype == dtype
    assert float((out.float() - want).abs().max()) <= TOL[dtype]
    assert float((lse - want_lse).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rot_forward_kernel_is_bitwise_repeatable(dtype):
    """Two K1 calls on the same inputs give the same bits: each block owns
    its rows and sums in a fixed order."""
    dev = _card()
    H, lens = 2, [388, 291, 97, 1]
    args = _inputs("rot", len(lens) * H, H, 388, 40, 320, lens, dtype, dev)
    first = rot_attention_forward(*args)
    second = rot_attention_forward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,dk,M,lens", [
    (29, 9, 21, [29, 11]),      # odd widths: 4-byte copies / registers
    (70, 40, 600, [70, 33]),    # E = 640: one tile buffer, two column chunks
    (45, 64, 1280, [45, 1, 17]),  # dk <= 64 too wide for a block: wide form
    (29, 77, 301, [29, 11]),    # wide form, odd widths
])
def test_rot_backward_kernel_copy_routes(dtype, T, dk, M, lens):
    """K2's other routes into shared memory, against the plain backward
    (the forward's out and lse from the plain forward)."""
    dev = _card()
    H = 2
    args = _inputs("rot", len(lens) * H, H, T, dk, M, lens, dtype, dev)
    out, lse = rot_attention_reference(*args)
    out = out.to(dtype)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, dtype)
    grads = rot_attention_backward(*args, out, lse, dout)
    torch.cuda.synchronize()
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = rot_attention_backward_reference(*f32, out.float(), lse,
                                            dout.float())
    for i, (g, w) in enumerate(zip(grads, want)):
        err = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert err <= TOL[dtype], (i, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rot_backward_kernel_is_bitwise_repeatable(dtype):
    """Two K2 calls on the same inputs give the same bits: each pass owns
    what it writes and sums in a fixed order, with no atomics."""
    dev = _card()
    H, lens = 2, [388, 291, 97, 1]
    args = _inputs("rot", len(lens) * H, H, 388, 40, 320, lens, dtype, dev)
    out, lse = rot_attention_forward(*args)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, dtype)
    first = rot_attention_backward(*args, out, lse, dout)
    second = rot_attention_backward(*args, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rot_wide_backward_kernel_is_bitwise_repeatable(dtype):
    """The wide K2 (the 1B config's dk = 80, M = 1280) as well: its key
    pass writes each dz tile once, its query pass sums them in order."""
    dev = _card()
    H, lens = 2, [388, 291, 97, 1]
    args = _inputs("rot", len(lens) * H, H, 388, 80, 1280, lens, dtype, dev)
    out, lse = rot_attention_forward(*args)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, dtype)
    first = rot_attention_backward(*args, out, lse, dout)
    second = rot_attention_backward(*args, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,dk,M,lens", [
    (300, dk, 16 * dk, [300, 151, 1, 0]) for dk in (40, 64, 80, 96, 128)] + [
    (45, 88, 1000, [45, 44, 1, 0]),   # dk, M off the 64-column boxes
    (130, 8, 8, [130, 129, 64, 1]),   # the narrowest rows; tile edges
])
def test_rot_wgmma_forms_match_plain(T, dk, M, lens):
    """K1 / K2's bf16 wgmma forms (csrc/rot_attention_sm90.cu,
    csrc/rot_attention_bwd_sm90.cu), called at each head width at M = 16
    dk (the routed call takes them from dk = 64 at these M) and at widths
    whose last box is part zero fill, ragged kv_len with a row at 1 and an
    empty row, against the plain versions in f32 (2e-2); K2 twice bitwise
    equal; each call one launch."""
    dev = _card()
    H = 2
    args = _inputs("rot", len(lens) * H, H, T, dk, M, lens, torch.bfloat16,
                   dev)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    n_fwd = rot_attention_forward_wgmma.launches
    n_bwd = rot_attention_backward_wgmma.launches
    out, lse = rot_attention_forward_wgmma(*args)
    torch.cuda.synchronize()
    want, want_lse = rot_attention_reference(*f32)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - want).abs().max()) <= TOL[torch.bfloat16]
    finite = torch.isfinite(want_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert float((lse - want_lse)[finite].abs().max()) <= TOL[torch.bfloat16]
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, torch.bfloat16)
    grads = rot_attention_backward_wgmma(*args, out, lse, dout)
    again = rot_attention_backward_wgmma(*args, out, lse, dout)
    torch.cuda.synchronize()
    assert rot_attention_forward_wgmma.launches == n_fwd + 1
    assert rot_attention_backward_wgmma.launches == n_bwd + 2
    wants = rot_attention_backward_reference(*f32, out.float(), lse,
                                             dout.float())
    empty = torch.from_numpy(np.repeat(np.asarray(lens) == 0, H)).to(dev)
    for i, (g, w, g2) in enumerate(zip(grads, wants, again)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2)
        err = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert err <= TOL[torch.bfloat16], (i, err)
        assert not bool(g[empty].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,dk,lens", [
    (33, 37, [33, 0, 20]),          # odd dk: 4-byte copies / registers
    (248, 37, [248, 0, 131, 1]),    # the served T, not a multiple of 32, 64
    (248, 38, [200, 0, 33]),        # bf16 pairs by 4-byte copies
    (80, 40, [80, 47, 1]),          # windows below row 0 and past 2T-2
    (33, 80, [33, 0, 20]),          # wide heads: bf16 staged raw
    (248, 128, [248, 0, 131, 1]),   # bf16 too wide to stage: registers
    (45, 77, [45, 0, 17]),          # odd wide dk: 4-byte copies / registers
])
def test_rel_forward_kernel_copy_routes(dtype, T, dk, lens):
    """K3's other routes into shared memory and its edges (T not a
    multiple of the block's rows, window rows outside the table in the
    first and last key tiles, an empty row), against the plain forward."""
    dev = _card()
    H = 2
    args = _inputs("rel", len(lens) * H, H, T, dk, 0, lens, dtype, dev)
    before = rel_attention_forward.launches
    out, lse = rel_attention_forward(*args)
    torch.cuda.synchronize()
    assert rel_attention_forward.launches == before + 1
    want, want_lse = rel_attention_reference(
        *[a.float() if a.is_floating_point() else a for a in args])
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert float((out.float() - want).abs().max()) <= TOL[dtype]
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    assert float((lse[finite] - want_lse[finite]).abs().max()) <= TOL[dtype]
    empty = torch.from_numpy(np.repeat(np.asarray(lens) == 0, H)).to(dev)
    assert not bool(out[empty].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_forward_kernel_is_bitwise_repeatable(dtype):
    """Two K3 calls on the same inputs give the same bits: each warp owns
    its rows and sums in a fixed order."""
    dev = _card()
    H, lens = 2, [388, 291, 97, 1]
    args = _inputs("rel", len(lens) * H, H, 388, 40, 0, lens, dtype, dev)
    first = rel_attention_forward(*args)
    second = rel_attention_forward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,dk,lens", [
    (33, 37, [33, 0, 20]),          # odd dk: 4-byte copies / registers
    (248, 37, [248, 0, 131, 1]),    # the served T, not a multiple of 32
    (248, 38, [200, 0, 33]),        # bf16 pairs by 4-byte copies
    (33, 80, [33, 0, 20]),          # wide heads: two output tiles a warp
    (248, 128, [248, 0, 131, 1]),   # the widest head, 16 output tiles
    (45, 77, [45, 0, 17]),          # odd wide dk: 4-byte copies / registers
])
def test_rel_backward_kernel_copy_routes(dtype, T, dk, lens):
    """K4's other routes into shared memory and its edges (T not a
    multiple of 32, window rows outside the table, an empty row), against
    the plain backward (the forward's out and lse from the plain
    forward)."""
    dev = _card()
    H = 2
    args = _inputs("rel", len(lens) * H, H, T, dk, 0, lens, dtype, dev)
    out, lse = rel_attention_reference(*args)
    out = out.to(dtype)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, dtype)
    grads = rel_attention_backward(*args, out, lse, dout)
    torch.cuda.synchronize()
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = rel_attention_backward_reference(*f32, out.float(), lse,
                                            dout.float())
    empty = torch.from_numpy(np.repeat(np.asarray(lens) == 0, H)).to(dev)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all())
        err = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert err <= TOL[dtype], (i, err)
        if i < 4:
            assert not bool(g[empty].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_backward_kernel_is_bitwise_repeatable(dtype):
    """Two K4 calls on the same inputs give the same bits: each pass owns
    what it writes, and dp's partials are added in a fixed order, with no
    atomics."""
    dev = _card()
    H, lens = 2, [388, 291, 97, 1]
    args = _inputs("rel", len(lens) * H, H, 388, 40, 0, lens, dtype, dev)
    out, lse = rel_attention_forward(*args)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(dev, dtype)
    first = rel_attention_backward(*args, out, lse, dout)
    second = rel_attention_backward(*args, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# the 1B stretch config's geometry (dk = 80), cut to 2 blocks
WIDE_1B = dict(idim=80, odim=50, encoder_attention_dim=1280,
               encoder_attention_heads=16, encoder_linear_units=5120,
               encoder_num_blocks=2, decoder_attention_dim=1280,
               decoder_attention_heads=16, decoder_linear_units=5120,
               decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
               encoder_selfattention_layer_type="rel_selfattn")


@pytest.mark.parametrize("flags,width", [
    ({"encoder_rot_fold_pallas": True}, "small"),
    ({"encoder_use_pallas_attention": True}, "small"),
    ({"encoder_use_pallas_attention": True}, "1b")])
def test_model_kernel_path_matches_plain_path(flags, width):
    dev = _card()
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    kw = dict(idim=80, odim=50, encoder_attention_dim=64,
              encoder_attention_heads=4, encoder_linear_units=128,
              encoder_num_blocks=2, decoder_attention_dim=64,
              decoder_attention_heads=4, decoder_linear_units=128,
              decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
              encoder_selfattention_layer_type="rel_selfattn")
    if width == "1b":
        kw = WIDE_1B
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


@pytest.mark.parametrize("flags,plain", [
    ({"encoder_rot_fold_pallas": True, "encoder_pos_dropout_mode": "rotated"},
     {"encoder_pos_dropout_mode": "rotated"}),          # A-train vs fold
    ({"encoder_use_pallas_attention": True}, {}),        # B-train vs table
])
def test_model_gradients_kernel_path_match_plain_path(flags, plain):
    """One train-mode loss and gradient (dropout 0, no SpecAugment) by the
    kernel path and by the plain path on the same weights: each gradient
    within 1e-3 of its largest magnitude, the zero-gradient leaves (key
    biases, the depthwise bias before the BatchNorm) ~0 in both."""
    dev = _card()
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    from lasr_tpu_torch.models.losses import E2E_Loss
    from lasr_tpu_torch.train.optimizer import Adam
    from lasr_tpu_torch.train.trainer import Trainer
    kw = dict(idim=80, odim=50, encoder_attention_dim=64,
              encoder_attention_heads=4, encoder_linear_units=128,
              encoder_num_blocks=2, decoder_attention_dim=64,
              decoder_attention_heads=4, decoder_linear_units=128,
              decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
              encoder_selfattention_layer_type="rel_selfattn",
              encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)
    rng = np.random.default_rng(0)
    n = np.asarray([48000, 40000, 20000], np.int32)
    wav = (0.1 * rng.standard_normal((3, 48000))).astype(np.float32)
    wav *= np.arange(48000)[None, :] < n[:, None]
    batch = {"wav_array": wav, "wav_len": n,
             "token_id": rng.integers(3, 50, (3, 9)).astype(np.int32),
             "token_len": np.asarray([9, 6, 4], np.int32)}
    torch.manual_seed(0)
    base = E2E_Conformer_CTC(**kw, **plain, device=dev)
    fast = E2E_Conformer_CTC(**kw, **flags, device=dev)
    fast.load_state_dict(base.state_dict())
    counters = ((rot_attention_forward, rot_attention_backward)
                if "encoder_rot_fold_pallas" in flags else
                (rel_attention_forward, rel_attention_backward))
    out = []
    for m in (fast, base):
        before = [c.launches for c in counters]
        metrics, grads = Trainer(m, E2E_Loss(50), Adam(),
                                 DeviceFrontend(["norm", "fbank:80"]),
                                 device=dev).loss_and_grads(batch, 0)
        out.append((float(metrics["loss_main"].detach()), grads,
                    [c.launches - b for c, b in zip(counters, before)]))
    (loss_k, grads_k, launched), (loss_p, grads_p, none) = out
    assert launched == [2, 2] and none == [0, 0]
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    top = max(float(g.abs().max()) for g in grads_p)
    names = [n for n, _ in base.named_parameters()]
    for name, a, b in zip(names, grads_k, grads_p):
        if name.endswith(ZERO_GRADIENT_LEAVES):
            assert max(float(a.abs().max()), float(b.abs().max())) \
                <= 1e-4 * top, name
        else:
            assert float((a - b).abs().max()) <= 1e-3 * float(
                b.abs().max()), name


def test_fit_cli_epoch_through_rel_kernels(tmp_path):
    """The train CLI on the card: a narrow B-train Conformer (2 blocks, 2
    heads of 16) on a 6-utterance corpus in batches of 3 and a 2-utterance
    dev set.  One epoch launches K3 twice per train step and validation
    batch and K4 twice per step; a run of 1 epoch resumed to 2 ends within
    1e-4 of an unbroken run of 2: the metric lines relative to each
    value, the weights (EMA included) against their largest magnitude.
    The zero-gradient leaves (a key bias; the depthwise bias before a
    BatchNorm) are left out of the weights: no output depends on them,
    their gradient is rounding noise that Adam turns into steps of +-lr
    (~1e-3 here), and the card's backward is not bitwise repeatable, so
    their signs differ between any two runs (1.05e-3 apart in a
    depthwise bias on the card)."""
    _card()
    import json
    from lasr_tpu_torch.bin import train
    from lasr_tpu_torch.utils.weights import checkpoint_name
    from tests.test_torch_port_cli import (TINY_CONFORMER, write_config,
                                           write_corpus)
    corpus = dict(n8=0, secs=(0.6, 1.4), n_words=(1, 3), word_len=(1, 4))
    trainset = write_corpus(str(tmp_path / "train"), n16=6, seed=1, **corpus)
    devset = write_corpus(str(tmp_path / "dev"), n16=2, seed=2, **corpus)
    config = write_config(
        str(tmp_path / "config.yaml"), trainset, devset,
        dict(TINY_CONFORMER, encoder_attention_dim=32,
             decoder_attention_dim=32, encoder_use_pallas_attention=True),
        train_batch=3, valid_batch=2, warm_step=100)

    def run(exp, epochs):
        rel_attention_forward.launches = rel_attention_backward.launches = 0
        assert train.main(["-config", config, "-exp_dir", str(tmp_path / exp),
                           "-num_epochs", str(epochs), "-ema", "1",
                           "-log_interval", "1", "-num_workers", "2"]) == 0
        torch.cuda.synchronize()
        with open(tmp_path / exp / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        return (rel_attention_forward.launches,
                rel_attention_backward.launches, lines)

    fwd, bwd, lines = run("resumed", 1)
    assert (fwd, bwd) == (2 * (2 + 1), 2 * 2)
    assert all(np.isfinite(v) for x in lines for v in x.values()
               if isinstance(v, float))
    _, _, full = run("unbroken", 2)
    fwd, bwd, resumed = run("resumed", 2)
    assert (fwd, bwd) == (2 * (2 + 1), 2 * 2)
    tail = [x for x in resumed if x["epoch"] == 1]
    want = [x for x in full if x["epoch"] == 1]
    assert len(tail) == len(want) == 3
    for a, b in zip(tail, want):
        for k in ("loss_main", "grad_norm", "lr", "valid_loss_main"):
            if k in b:
                assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
    sd = [torch.load(tmp_path / exp / "checkpoints" / "last" /
                     checkpoint_name(4), map_location="cpu",
                     weights_only=False)["state_dict"]
          for exp in ("resumed", "unbroken")]
    noise = tuple(n.replace(".", "") for n in ZERO_GRADIENT_LEAVES)
    floats = [k for k, v in sd[1].items() if torch.is_floating_point(v)
              and not k.replace(".", "").endswith(noise)]
    assert len(floats) < len(sd[1])
    top = max(float(sd[1][k].abs().max()) for k in floats)
    for k in floats:
        assert float((sd[0][k] - sd[1][k]).abs().max()) <= 1e-4 * top, k


def test_chunk_encoder_on_the_card_matches_cpu_and_chunk_serving():
    """The streaming encoder at full width (2 of its 12 blocks): the
    card's batch forward against the same weights on the CPU and against
    the card's own encode_chunk sequence, ragged key lengths, 1e-3."""
    dev = _card()
    import torch.nn.functional as F
    from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
    from lasr_tpu_torch.modules.streaming import _chunk_grid
    from lasr_tpu_torch.utils.weights import load_model_weights
    kw = dict(idim=80, odim=5002, encoder_attention_dim=320,
              encoder_attention_heads=8, encoder_linear_units=2048,
              encoder_num_blocks=2, decoder_attention_dim=320,
              decoder_self_attention_heads=8, decoder_src_attention_heads=8,
              decoder_linear_units=2048, decoder_num_block=1)
    torch.manual_seed(0)
    model = E2E_Transformer_CTC_Online(**kw, device=dev)
    cpu = E2E_Transformer_CTC_Online(**kw, device="cpu")
    load_model_weights(cpu, model.state_dict())
    rng = np.random.default_rng(0)
    T = 398
    x = torch.from_numpy(rng.standard_normal((3, T, 80)).astype(np.float32))
    xlen = torch.tensor([T, 301, 77])
    with torch.no_grad():
        hs, hs_len = model.encode_online(x.to(dev), xlen.to(dev))
        hs_cpu, len_cpu = cpu.encode_online(x, xlen)
        enc = model.encoder
        x_pad = F.pad(x.to(dev), (0, 0, 0, 134))
        mems = enc.init_stream_state(3)
        outs = []
        for c in range(_chunk_grid(T, 64, 64, 64)):
            out, mems = enc.encode_chunk(x_pad[:, c * 64: c * 64 + 134], c,
                                         mems, xlen.to(dev))
            outs.append(out)
        inc = torch.cat(outs, dim=1)
    assert torch.equal(hs_len.cpu(), len_cpu)
    assert float((hs.cpu() - hs_cpu).abs().max()) <= 1e-3
    for b, n in enumerate(hs_len.tolist()):
        assert float((inc[b, :n] - hs[b, :n]).abs().max()) <= 1e-3


@pytest.mark.parametrize("flags", [{}, {"encoder_use_pallas_attention": True}])
def test_two_gloo_ranks_on_the_card_equal_one_process(flags, tmp_path):
    """Two ``gloo`` ranks sharing the card against the one-process step on
    the same global batch (a pad row on rank 1, SpecAugment on), the
    table configuration and B-train's (K3 + K4); the ranks bitwise equal.
    Each rank's GEMMs and convolutions run at half the batch, which the
    card tiles and sums in another order than the one-process step.
    B-train is held within 1e-5, as ``test_torch_port_dp.py`` holds the
    step on the CPU, but for the biases in front of the conv module's
    BatchNorm (``norm_conv.bias``, ``pointwise_conv1.bias``), whose
    gradient BatchNorm nearly cancels (a difference of nearly equal sums
    over B x T) and which are held at 1e-4: ``pointwise_conv1.bias`` came
    out at 1.11e-5 (relative L2) in B-train and ``norm_conv.bias`` at
    1.03e-5 in the table configuration.  The table configuration, whose
    attention runs as batched GEMMs, is held at this file's f32
    tolerance, 1e-4: in a second card run nine more of its gradient
    leaves, of FF, norm and conv-module weights, came out at 1.03e-5 to
    1.25e-5.  Readings on an NVIDIA H100 80GB HBM3 at 700.00 W."""
    from lasr_tpu_torch.parallel import dist
    from tests.torch_port_dp_worker import (KW, assert_step_equal,
                                            build_trainer, ranks_result,
                                            run_steps, start_ranks,
                                            wav_batch)
    dev = _card()
    spec = dict(kw=dict(KW, **flags), chain=["norm", "fbank:20", "specaug"],
                adam=dict(lr=1e-3, eps=1e-3), acc_grads=1, device="cuda:0",
                batches=[wav_batch(0, 3, 3), wav_batch(1, 4, 4)])
    torch.manual_seed(0)
    model, trainer = build_trainer(spec, dev)
    spec["init"] = {k: v.cpu() for k, v in model.state_dict().items()}
    worker = start_ranks(str(tmp_path), spec)
    want = run_steps(trainer, model, spec["batches"],
                     lambda b: dist.pad_rows(b, 2))
    if flags:
        tol, loose = 1e-5, {"norm_conv.bias": 1e-4,
                            "conv_module.pointwise_conv1.bias": 1e-4}
    else:
        tol, loose = TOL[torch.float32], None
    assert_step_equal(ranks_result(str(tmp_path), worker), want, tol, loose)


def test_nccl_ranks_on_every_card_equal_one_process(tmp_path):
    """One NCCL rank per card (up to 4; needs two cards) against the
    one-process step on the same global batch (B=7, so pad rows land on
    the last rank; SpecAugment on, the rel kernels), at this file's f32
    tolerance; every rank bitwise equal to rank 0."""
    from lasr_tpu_torch.parallel import dist
    from tests.torch_port_dp_worker import (KW, assert_step_equal,
                                            build_trainer, ranks_result,
                                            run_steps, start_ranks,
                                            wav_batch)
    dev = _card()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    spec = dict(kw=dict(KW, encoder_use_pallas_attention=True),
                chain=["norm", "fbank:20", "specaug"],
                adam=dict(lr=1e-3, eps=1e-3), acc_grads=1, device="cuda",
                backend="nccl", ranks=n,
                batches=[wav_batch(0, 7, 7), wav_batch(1, 8, 8)])
    torch.manual_seed(0)
    model, trainer = build_trainer(spec, dev)
    spec["init"] = {k: v.cpu() for k, v in model.state_dict().items()}
    worker = start_ranks(str(tmp_path), spec)
    want = run_steps(trainer, model, spec["batches"],
                     lambda b: dist.pad_rows(b, n))
    assert_step_equal(ranks_result(str(tmp_path), worker, n), want,
                      TOL[torch.float32])


def test_train_cli_on_every_card_equals_one_card(tmp_path):
    """``python -m lasr_tpu_torch.bin.train`` with the default
    ``-num_devices -1`` on a machine with two or more cards (one NCCL rank
    each) against ``-num_devices 1``, both padding batches to the card
    count, dropout 0, no SpecAugment, the rel kernels, Adam eps 1e-3 (the
    leaves whose true gradient is 0 hold rounding noise that the default
    eps turns into +-lr a step, test_torch_port_trainer.py): 2 epochs
    with validation; every metrics line within 1e-4 (relative) and the
    final weights within 1e-4 of their largest magnitude; rank 0 alone
    wrote."""
    import json
    import os
    import yaml
    from tests.test_torch_port_cli import (TINY_CONFORMER, write_config,
                                           write_corpus)
    from tests.torch_port_dp_worker import Worker
    _card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    corpus = dict(n8=0, secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    train = write_corpus(str(tmp_path / "train"), n16=9, seed=31, **corpus)
    valid = write_corpus(str(tmp_path / "dev"), n16=3, seed=32, **corpus)
    kw = dict(TINY_CONFORMER, encoder_use_pallas_attention=True,
              encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)
    config = write_config(str(tmp_path / "config.yaml"), train, valid, kw,
                          train_batch=5, valid_batch=3)
    with open(config) as f:
        cfg = yaml.safe_load(f)
    for key in ("train_data_config", "valid_data_config"):
        cfg[key]["kwargs"]["batch_pad_multiple"] = n
    cfg["opti_config"]["kwargs"]["eps"] = 1e-3
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    flags = ["-config", config, "-num_epochs", "2", "-ema", "1",
             "-log_interval", "1", "-num_workers", "1"]
    runs = {name: Worker(flags + ["-exp_dir", str(tmp_path / name)] + extra,
                         str(tmp_path), module="lasr_tpu_torch.bin.train",
                         name=name)
            for name, extra in (("one", ["-num_devices", "1"]),
                                ("every", []))}
    outs = {}
    for name, w in runs.items():
        rc, outs[name] = w.wait()
        assert rc == 0, outs[name][-6000:]
    assert f"backend nccl, world size {n}" in outs["every"]
    assert sorted(os.listdir(tmp_path / "every")) == [
        "checkpoints", "hparams.yaml", "metrics.jsonl"]
    lines = {}
    for name in runs:
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines[name] = [json.loads(x) for x in f]
    assert [(x["epoch"], x["step"]) for x in lines["every"]] == \
        [(x["epoch"], x["step"]) for x in lines["one"]]
    for a, b in zip(lines["every"], lines["one"]):
        for k in ("loss_main", "att_loss", "ctc_loss", "grad_norm",
                  "valid_loss_main", "valid_ctc_cer"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    last = [sorted((tmp_path / name / "checkpoints" / "last").iterdir())[-1]
            for name in ("every", "one")]
    got, want = [torch.load(p, map_location="cpu",
                            weights_only=False)["state_dict"] for p in last]
    top = max(float(v.abs().max()) for v in want.values()
              if v.is_floating_point())
    for k, v in want.items():
        if v.is_floating_point():
            assert float((got[k] - v).abs().max()) <= 1e-4 * top, k


@pytest.mark.parametrize("out_len", [0, 5])
def test_ctc_prefix_parallel_scan_on_the_card(out_len):
    """The search's CTC prefix step at the served shape (B=8, beam 10,
    ctc_beam 15, T=248; row 1 padded past frame 200): the doubling scan
    (``parallel_scan=True``) on the card against the loop over frames on
    the card and against the scan on the CPU, each entry within 1e-4 of
    its magnitude (at least 1: r reaches ~1,700, where a float32 spacing
    is 1.2e-4), the LOG_ZERO floor at the same entries."""
    dev = _card()
    from lasr_tpu_torch.decode.beam import (LOG_ZERO, _ctc_initial_state,
                                            _ctc_prefix_step)
    rng = np.random.default_rng(out_len)
    B, K, C, T, V = 8, 10, 15, 248, 500
    lpz = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((B, T, V)).astype(np.float32)), dim=-1)
    lpz[1, 200:] = LOG_ZERO
    lpz[1, 200:, 0] = 0.0
    r = _ctc_initial_state(lpz, 0)[:, None].expand(B, K, T, 2).clone()
    r[..., 0] = r[..., 1] + torch.from_numpy(
        rng.standard_normal((B, K, T)).astype(np.float32))
    last = torch.from_numpy(rng.integers(1, V, (B, K)))
    cand = torch.from_numpy(rng.integers(0, V, (B, K, C)))
    cand[:, :, 0] = last
    args = (lpz, r, last, cand)
    card = {flag: _ctc_prefix_step(*(a.to(dev) for a in args), out_len, 0,
                                   want_psi_all=True, parallel_scan=flag)
            for flag in (True, False)}
    cpu = _ctc_prefix_step(*args, out_len, 0, want_psi_all=True,
                           parallel_scan=True)
    for name, got, loop, want in zip(("psi", "r_new", "psi_all"),
                                     card[True], card[False], cpu):
        got = got.cpu()
        assert bool((got[got <= LOG_ZERO] == LOG_ZERO).all()), name
        for ref in (loop.cpu(), want):
            floor = ref <= LOG_ZERO
            assert torch.equal(got <= LOG_ZERO, floor), name
            err = (got - ref).abs() / ref.abs().clamp(min=1.0)
            assert float(err[~floor].max()) <= 1e-4, name
