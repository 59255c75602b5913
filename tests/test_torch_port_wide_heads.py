"""Wide attention heads (the 1B stretch config, example/pretrain_1b: d =
1280, 16 heads, dk = 80) in the port on the CPU.

  - K3 / K4's plain versions against ``lasr_tpu``'s Pallas kernels in
    interpret mode at dk = 80 and 128, forward and backward: f32 within
    2e-5 (``test_torch_port_attention_ops.py`` / ``_bwd.py``'s bar), bf16
    within 2e-2 of each tensor's largest magnitude
    (``test_torch_port_bf16.py``'s bar).
  - The 1B block geometry at depth 2 (two Conformer blocks and one
    decoder block at d = 1280, 16 heads, 5,120 units, a short input) in
    configuration B (the rel kernels): att_out and ctc_out within 2e-4 of
    ``lasr_tpu``'s on bridged weights.
  - K1 / K2's refusal before a launch where they cannot run (dk > 64, or
    a [q_u ; u] row too wide for a block's shared memory, as at the 1B
    geometry), and K3 / K4's (dk > 128); the CPU path is unaffected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.ops.rel_attention import (_rel_attention_pallas,
                                        _rel_attention_pallas_bwd)
from lasr_tpu_torch.ops import rel_attention as rel
from lasr_tpu_torch.ops import rot_attention as rot
from tests.torch_port_common import CONFIGS, data, model_pair, t

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


@pytest.mark.parametrize("dk,M,backward,fits", [
    (40, 320, False, True),       # the recipe's K1
    (40, 320, True, True),        # its K2
    (64, 320, True, True),
    (80, 1280, False, False),     # the 1B geometry: dk and M both refuse
    (64, 1280, False, False),     # M alone: [q_u ; u] overflows a block
    (64, 1280, True, False),
    (80, 64, False, False),       # dk alone
])
def test_rot_kernels_refuse_before_launch(dk, M, backward, fits):
    check = lambda: rot.check_rot_kernel_shape(  # noqa: E731
        "rot_attention", dk, M, backward)
    if fits:
        check()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        check()


def test_rot_wrapper_refuses_on_cuda_before_launch(monkeypatch):
    """The wrapper's CUDA path checks the shape before it builds or
    launches anything (a CPU tensor stands in, routed as CUDA)."""
    monkeypatch.setattr(rot, "_device_path", lambda name, device: True)
    monkeypatch.setattr(rot, "_smem_limit", lambda device: 232448)
    monkeypatch.setattr(rot, "_bind", lambda *a: pytest.fail("launched"))
    BH, T, dk, M = 2, 5, 80, 1280
    z = lambda *s: torch.zeros(s)  # noqa: E731
    kv = torch.full((BH,), T, dtype=torch.int32)
    before = rot.rot_attention_forward.launches
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        rot.rot_attention_forward(z(BH, T, dk), z(BH, T, M), z(BH, T, dk),
                                  z(BH, T, dk), z(T, M), kv)
    assert rot.rot_attention_forward.launches == before
    # on the CPU the plain version takes any width
    monkeypatch.undo()
    out, _ = rot.rot_attention_forward(z(BH, T, dk), z(BH, T, M),
                                       z(BH, T, dk), z(BH, T, dk), z(T, M),
                                       kv)
    assert out.shape == (BH, T, dk)


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
