"""Wide attention heads (the 1B stretch config, example/pretrain_1b: d =
1280, 16 heads, dk = 80) in the port on the CPU.

  - K1-K4's plain versions against ``lasr_tpu``'s Pallas kernels in
    interpret mode, forward and backward: K3 / K4 at dk = 80 and 128, K1 /
    K2 at (dk, M) = (80, 1280), the 1B config's, and (128, 256); f32
    within 2e-5 (``test_torch_port_attention_ops.py`` / ``_bwd.py``'s
    bar), bf16 within 2e-2 of each tensor's largest magnitude
    (``test_torch_port_bf16.py``'s bar).
  - The 1B block geometry at depth 2 (two Conformer blocks and one
    decoder block at d = 1280, 16 heads, 5,120 units, a short input) in
    configuration B (the rel kernels): att_out and ctc_out within 2e-4 of
    ``lasr_tpu``'s on bridged weights; and at depth 1 + 1 in
    configuration A (the rot kernels, rotated positional dropout): the
    forward, and one dropout-0 train step's gradients against
    ``lasr_tpu``'s Trainer, within 2e-4.
  - K1 / K2 take every head width up to 128 at any M (the narrow form
    where its tiles fit a block, else the wide form), and refuse dk > 128
    before a launch, as K3 / K4 do; the CPU path takes any width.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.ops.rel_attention import (_rel_attention_pallas,
                                        _rel_attention_pallas_bwd)
from lasr_tpu.ops.rot_attention import (_rot_attention_pallas,
                                        _rot_attention_pallas_bwd)
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.ops import rel_attention as rel
from lasr_tpu_torch.ops import rot_attention as rot
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import Trainer
from lasr_tpu_torch.utils.weights import load_model_weights
from tests.torch_port_common import (CONFIGS, data, flax_state_dict,
                                     jax_grad, model_pair, t)

H = 2
F32_TOL, BF16_TOL = 2e-5, 2e-2


def _case(T, dk, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lens = np.asarray([T, max(1, T - 19)], np.int32)
    return ([f(2 * H, T, dk) for _ in range(4)] + [f(H, 2 * T - 1, dk)],
            np.repeat(lens, H), f(2 * H, T, dk))


def _rel_max_err(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,dk", [(37, 80), (33, 128)])
def test_plain_k3_k4_match_pallas_at_wide_heads(T, dk, dtype):
    xs, kv, dout = _case(T, dk, seed=dk)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(x, jdt) for x in xs]
    # the same (rounded) values on both sides
    tx = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    jd = jnp.asarray(dout, jdt)
    td = torch.from_numpy(np.asarray(jd.astype(jnp.float32))).to(tdt)
    jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv)
    out, lse = _rel_attention_pallas(*jx, jkv, H=H, interpret=True)
    got, got_lse = rel.rel_attention_forward(*tx, tkv)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=tol)
    else:
        assert _rel_max_err(got, out) < tol
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5)

    want = _rel_attention_pallas_bwd(*jx, jkv, out, lse, jd, H=H,
                                     interpret=True)
    t_out = torch.from_numpy(np.asarray(out.astype(jnp.float32))).to(tdt)
    grads = rel.rel_attention_backward(*tx, tkv, t_out,
                                       torch.from_numpy(np.asarray(lse)), td)
    assert len(grads) == len(want) == 5
    for g, w in zip(grads, want):
        assert g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
        else:
            assert _rel_max_err(g, w) < tol


def _rot_case(T, dk, M, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(  # noqa: E731
        np.float32)
    lens = np.asarray([T, max(1, T - 19)], np.int32)
    return ([f(2 * H, T, dk), f(2 * H, T, M, sc=0.3), f(2 * H, T, dk),
             f(2 * H, T, dk), f(T, M, sc=0.3)], np.repeat(lens, H),
            f(2 * H, T, dk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,dk,M", [(37, 80, 1280), (33, 128, 256),
                                     (40, 80, 160)])
def test_plain_k1_k2_match_pallas_at_wide_heads(T, dk, M, dtype):
    xs, kv, dout = _rot_case(T, dk, M, seed=dk)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(x, jdt) for x in xs]
    tx = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    jd = jnp.asarray(dout, jdt)
    td = torch.from_numpy(np.asarray(jd.astype(jnp.float32))).to(tdt)
    jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv)
    out, lse = _rot_attention_pallas(*jx, jkv, interpret=True)
    got, got_lse = rot.rot_attention_forward(*tx, tkv)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=tol)
    else:
        assert _rel_max_err(got, out) < tol
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5)

    want = _rot_attention_pallas_bwd(*jx, jkv, out, lse, jd, interpret=True)
    t_out = torch.from_numpy(np.asarray(out.astype(jnp.float32))).to(tdt)
    grads = rot.rot_attention_backward(*tx, tkv, t_out,
                                       torch.from_numpy(np.asarray(lse)), td)
    assert len(grads) == len(want) == 4
    for g, w in zip(grads, want):
        assert g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
        else:
            assert _rel_max_err(g, w) < tol


# the 1B config's geometry (example/pretrain_1b/conf/config.yaml), cut to
# two encoder blocks and one decoder block and a vocabulary of 50
WIDE = dict(idim=20, odim=50, encoder_attention_dim=1280,
            encoder_attention_heads=16, encoder_linear_units=5120,
            encoder_num_blocks=2, decoder_attention_dim=1280,
            decoder_attention_heads=16, decoder_linear_units=5120,
            decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
            encoder_selfattention_layer_type="rel_selfattn",
            encoder_cnn_kernel=7)


def test_1b_block_geometry_forward_matches_lasr_tpu():
    fm, variables, pm = model_pair(CONFIGS["B"], seed=2, **WIDE)
    assert pm.encoder.encoders[0].self_attn.d_k == 80
    x, xlen, ys = data(D=WIDE["idim"], odim=WIDE["odim"], seed=12)
    want = fm.apply(variables, jnp.asarray(x), jnp.asarray(xlen),
                    jnp.asarray(ys))
    before = rel.rel_attention_forward.launches
    with torch.no_grad():
        got = pm(t(x), t(xlen), t(ys).long())
    # the CPU tensors took the plain version
    assert rel.rel_attention_forward.launches == before
    np.testing.assert_array_equal(got["hs_len"].numpy(),
                                  np.asarray(want["hs_len"]))
    np.testing.assert_allclose(got["att_out"].numpy(),
                               np.asarray(want["att_out"]), atol=2e-4)
    for b, n in enumerate(np.asarray(want["hs_len"])):
        np.testing.assert_allclose(got["ctc_out"][b, :n].numpy(),
                                   np.asarray(want["ctc_out"])[b, :n],
                                   atol=2e-4)


# configuration A (the rot kernels) in rotated mode at the 1B geometry,
# 1 + 1 blocks, dropout 0: the forward and one train step's gradients
WIDE_A = dict(WIDE, encoder_num_blocks=1, encoder_rot_fold_pallas=True,
              encoder_pos_dropout_mode="rotated", encoder_dropout_rate=0.0,
              decoder_dropout_rate=0.0, ctc_dropout=0.0)


def test_1b_block_geometry_config_a_matches_lasr_tpu():
    rng = np.random.default_rng(3)
    n = np.asarray([8000, 6400], np.int32)
    wav = (0.2 * rng.standard_normal((2, 8000))).astype(np.float32)
    wav *= np.arange(8000)[None, :] < n[:, None]
    batch = {"wav_array": wav, "wav_len": n,
             "token_id": rng.integers(3, WIDE["odim"], (2, 5)).astype(
                 np.int32),
             "token_len": np.asarray([5, 3], np.int32)}
    chain = ["norm", f"fbank:{WIDE['idim']}"]
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**WIDE_A),
                    JaxLoss(WIDE["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam().make(), JaxFrontend(chain),
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=False,
                    seed=0, log_interval=1)
    jstate = jt.init_state(batch)
    model = E2E_Conformer_CTC(**WIDE_A, device="cpu")
    assert model.encoder.encoders[0].self_attn.d_k == 80
    load_model_weights(model, flax_state_dict(jstate.params,
                                              jstate.batch_stats))
    pt = Trainer(model, E2E_Loss(WIDE["odim"], smoothing=0.1, rate=0.3),
                 Adam(), DeviceFrontend(chain), use_ema=False, seed=0,
                 log_interval=1, device="cpu")
    counters = (rot.rot_attention_forward, rot.rot_attention_backward)
    before = [c.launches for c in counters]
    # the step's BatchNorm update is put back for the forward below
    start = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, grads = pt.loss_and_grads(batch, 0)
    model.load_state_dict(start)
    # the CPU tensors took the plain versions
    assert [c.launches for c in counters] == before
    want_loss, want = jax_grad(jt, jstate, batch, with_loss=True)
    want = flax_state_dict(want)
    np.testing.assert_allclose(float(metrics["loss_main"].detach()),
                               float(want_loss),
                               rtol=2e-4)
    assert len(grads) == len(want)
    for name, g in zip(pt.names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4 * max(
            1.0, float(np.abs(w).max())), err_msg=name)

    # the forward in eval mode
    x, xlen, ys = data(D=WIDE["idim"], odim=WIDE["odim"], seed=13)
    fm = jax_models.E2E_Conformer_CTC(**WIDE_A)
    out = fm.apply({"params": jstate.params,
                    "batch_stats": jstate.batch_stats}, jnp.asarray(x),
                   jnp.asarray(xlen), jnp.asarray(ys))
    model.eval()
    with torch.no_grad():
        got = model(t(x), t(xlen), t(ys).long())
    np.testing.assert_allclose(got["att_out"].numpy(),
                               np.asarray(out["att_out"]), atol=2e-4)
    for b, n in enumerate(np.asarray(out["hs_len"])):
        np.testing.assert_allclose(got["ctc_out"][b, :n].numpy(),
                                   np.asarray(out["ctc_out"])[b, :n],
                                   atol=2e-4)


@pytest.mark.parametrize("dk,M,backward,narrow", [
    (40, 320, False, True),       # the recipe's K1: the narrow form
    (40, 320, True, True),        # its K2
    (64, 320, True, True),
    (80, 1280, False, False),     # the 1B geometry: the wide form
    (64, 1280, False, False),     # M alone: [q_u ; u] overflows a block
    (64, 1280, True, False),
    (80, 64, False, False),       # dk alone
    (80, 1280, True, False),
    (96, 1536, False, False),
    (128, 2048, False, False),
    (128, 2048, True, False),
    (40, 2048, True, False),
])
def test_rot_kernels_refuse_before_launch(dk, M, backward, narrow):
    """K1 / K2 take every dk <= 128 at any M the tests use up to 2,048:
    the narrow form where its tiles fit a block, else the wide one, whose
    shared memory does not grow with M and fits the H100's."""
    rot.check_rot_kernel_shape("rot_attention", dk, M, backward)
    assert rot.rot_kernel_wide(dk, M, backward) == (not narrow)
    need = rot.rot_kernel_smem_bytes(dk, M, backward)
    assert need <= rot.SMEM_PER_BLOCK
    if not narrow:   # the wide form's does not grow with M
        assert need == rot.rot_kernel_smem_bytes(dk, 4096, backward)


@pytest.mark.parametrize("backward", [False, True])
def test_rot_kernels_refuse_heads_above_128(backward):
    with pytest.raises(ValueError, match="up to 128"):
        rot.check_rot_kernel_shape("rot_attention", 136, 320, backward)


def test_rot_wrapper_refuses_on_cuda_before_launch(monkeypatch):
    """The wrapper's CUDA path checks the shape before it builds or
    launches anything, and picks the wide form's entry point at the 1B
    geometry (a CPU tensor stands in, routed as CUDA)."""
    bound = []

    class Bound(Exception):
        pass

    def bind(source, symbol, n_ptr, n_int):
        bound.append((symbol, n_ptr))
        raise Bound
    monkeypatch.setattr(rot, "_device_path", lambda name, device: True)
    monkeypatch.setattr(rot, "_smem_limit", lambda device: 232448)
    monkeypatch.setattr(rot, "_bind", bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    z = lambda *s: torch.zeros(s)  # noqa: E731
    BH, T = 2, 5
    kv = torch.full((BH,), T, dtype=torch.int32)

    def args(dk, M):
        return (z(BH, T, dk), z(BH, T, M), z(BH, T, dk), z(BH, T, dk),
                z(T, M), kv)
    before = rot.rot_attention_forward.launches
    with pytest.raises(ValueError, match="up to 128"):
        rot.rot_attention_forward(*args(136, 320))
    with pytest.raises(ValueError, match="up to 128"):
        rot.rot_attention_backward(*args(136, 320), z(BH, T, 136),
                                   torch.zeros(BH, T), z(BH, T, 136))
    assert bound == []
    for dk, M, wide in ((40, 320, False), (80, 1280, True)):
        with pytest.raises(Bound):
            rot.rot_attention_forward(*args(dk, M))
        with pytest.raises(Bound):
            rot.rot_attention_backward(*args(dk, M), z(BH, T, dk),
                                       torch.zeros(BH, T), z(BH, T, dk))
    assert bound == [("lasr_rot_attention_fwd", 8),
                     ("lasr_rot_attention_bwd", 14),
                     ("lasr_rot_attention_fwd_wide", 8),
                     ("lasr_rot_attention_bwd_wide", 15)]
    assert rot.rot_attention_forward.launches == before
    # on the CPU the plain version takes any width
    monkeypatch.undo()
    out, _ = rot.rot_attention_forward(*args(136, 1280))
    assert out.shape == (BH, T, 136)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_rel_wrapper_refuses_heads_above_128(which, monkeypatch):
    monkeypatch.setattr(rel, "_device_path", lambda name, device: True)
    monkeypatch.setattr(rel, "_bind", lambda *a: pytest.fail("launched"))
    BH, T, dk = 2, 5, 136
    z = lambda *s: torch.zeros(s)  # noqa: E731
    args = [z(BH, T, dk)] * 4 + [z(1, 2 * T - 1, dk),
                                 torch.full((BH,), T, dtype=torch.int32)]
    with pytest.raises(ValueError, match="up to 128"):
        if which == "forward":
            rel.rel_attention_forward(*args)
        else:
            rel.rel_attention_backward(*args, z(BH, T, dk),
                                       torch.zeros(BH, T), z(BH, T, dk))
