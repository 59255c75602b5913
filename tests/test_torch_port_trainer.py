"""The port's Trainer against lasr_tpu's, f32, TINY widths: 3 train steps
from the same weights (the JAX trainer's init, bridged), dropout 0, no
SpecAugment, EMA on, Adam(lr=1e-3, eps=1e-3), in the table, A-train
(rotated fold through the rot kernels) and B-train (rel kernels)
configurations:

  - loss and grad_norm of every step within 1e-4 (and the other metrics);
  - parameters, BatchNorm statistics and the EMA shadow after 3 steps
    within 1e-4; the trained state_dict also reads back into a Flax tree
    through lasr_tpu's ``torch_to_flax``.

Some gradients are 0 in exact arithmetic and rounding noise in f32: the
depthwise conv's bias feeds a train-mode BatchNorm, which removes any
per-channel constant; an attention's key bias adds the same q·b_k to every
score of a row, which the softmax removes; so do the near-constant
low-frequency columns of the positional table through ``linear_pos``.
Adam with its default eps turns such noise into +-lr, so the two
frameworks' weights would part by ~lr there.  The steps therefore run
Adam with eps = 1e-3, far above the noise (~1e-8) and below the real
gradients, and the two named leaves' gradients are checked to be ~0 in
both frameworks (lasr_tpu's in the table configuration).  The default
eps is held to optax in ``test_torch_port_losses.py``.

And a checkpoint written by the port decodes, through lasr_tpu's
ASRProcess and the port's, to the same tokens.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu.utils.torch_compat import torch_to_flax
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.data.reader import write_wav
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import METRICS, Trainer
from lasr_tpu_torch.utils.weights import (load_model_weights,
                                          state_dict_to_numpy)
from tests.torch_port_common import TINY, flax_state_dict, jax_grad

TOL = 1e-4
KW = dict(TINY, encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
          ctc_dropout=0.0)
CONFIGS = {
    "table": {},
    "A-train": {"encoder_rot_fold_pallas": True,
                "encoder_pos_dropout_mode": "rotated"},
    "B-train": {"encoder_use_pallas_attention": True},
}
CHAIN = ["norm", "fbank:20"]
NOISE_LEAVES = ("conv_module.depthwise_conv.bias", "linear_k.bias")
ADAM = dict(lr=1e-3, eps=1e-3)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n = np.asarray([8000, 5600, 6400], np.int32)
    wav = (0.2 * rng.standard_normal((3, 8000))).astype(np.float32)
    wav *= np.arange(8000)[None, :] < n[:, None]
    return {"wav_array": wav, "wav_len": n,
            "token_id": rng.integers(3, TINY["odim"], (3, 6)).astype(np.int32),
            "token_len": np.asarray([6, 4, 5], np.int32)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_three_steps_match_jax_trainer(config):
    kw = dict(KW, **CONFIGS[config])
    batch = _batch()
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**kw),
                    JaxLoss(TINY["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(CHAIN),
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1)
    jstate = jt.init_state(batch)
    model = E2E_Conformer_CTC(**kw, device="cpu")
    load_model_weights(model, flax_state_dict(jstate.params,
                                              jstate.batch_stats))
    pt = Trainer(model, E2E_Loss(TINY["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True, seed=0,
                 log_interval=1, device="cpu")

    # the noise leaves' gradients, at the start: ~0 in the port, and in
    # lasr_tpu (its gradient compiles one more program, so once)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _, grads = pt.loss_and_grads(batch, 0)
    model.load_state_dict(start)
    noisy = [n for n in pt.names if n.endswith(NOISE_LEAVES)]
    assert len(noisy) == 2 * TINY["encoder_num_blocks"] \
        + 2 * TINY["decoder_num_block"]
    jgrads = flax_state_dict(jax_grad(jt, jstate, batch)) \
        if config == "table" else {}
    for name, g in zip(pt.names, grads):
        if name in noisy:
            assert float(g.abs().max()) < 1e-5
            if jgrads:
                assert float(jgrads[name].abs().max()) < 1e-5

    pstate = pt.init_state()
    for step in range(3):
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        assert set(pm) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k} step {step}")

    want = flax_state_dict(jstate.params, jstate.batch_stats)
    got = model.state_dict()
    want_ema = flax_state_dict(jstate.ema["shadow"])
    shadow = dict(zip(pt.names, pstate.ema["shadow"]))
    assert int(jstate.ema["num_updates"]) == pstate.ema["num_updates"] == 3
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=k)
        if k in shadow:
            np.testing.assert_allclose(shadow[k].numpy(),
                                       want_ema[k].numpy(), atol=TOL,
                                       err_msg=k)
    # the step back: the trained state_dict read by lasr_tpu's own bridge
    back = torch_to_flax(state_dict_to_numpy(got))
    np.testing.assert_allclose(
        np.asarray(back["batch_stats"]["encoder"]["layers_0"]["conv_module"]
                   ["norm"]["var"]),
        np.asarray(jstate.batch_stats["encoder"]["layers_0"]["conv_module"]
                   ["norm"]["var"]), atol=TOL)


def test_port_checkpoint_decodes_alike_in_both_packages(tmp_path):
    kw = dict(KW, **CONFIGS["A-train"])
    batch = _batch(1)
    torch.manual_seed(0)
    model = E2E_Conformer_CTC(**kw, device="cpu")
    pt = Trainer(model, E2E_Loss(TINY["odim"]), Adam(lr=1e-2),
                 DeviceFrontend(CHAIN), exp_dir=str(tmp_path), use_ema=True,
                 device="cpu")
    state = pt.init_state()
    for _ in range(2):
        state, _ = pt.train_step(state, batch)
    ckpt = pt.save_checkpoint(state)
    assert ckpt.endswith(".ckpt")
    (tmp_path / "dict.txt").write_text("\n".join("ABC"))
    pt.save_hparams({
        "model_config": {
            "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
            "kwargs": kw},
        "tokenizer_config": {
            "name": "lasr_tpu.data.tokenizer:CharTokenizer",
            "kwargs": {"dict_path": str(tmp_path / "dict.txt")}}})
    with open(tmp_path / "decode.yaml", "w") as f:
        yaml.safe_dump({"decode_config": {"decode_method": "ctc_att",
                                          "beam": 3, "ctc_beam": 4,
                                          "ctc_weight": 0.5, "lm_rate": 0},
                        "test_data_config": {"kwargs": {
                            "audio_trans": CHAIN}}}, f)
    wav_path = str(tmp_path / "x.wav")
    write_wav(wav_path, batch["wav_array"][0], 16000)
    args = (str(tmp_path / "hparams.yaml"), str(tmp_path / "decode.yaml"),
            ckpt)
    ours = ASRProcess(*args, device="cpu")
    ref = JaxASRProcess(*args)
    # the EMA shadow is what both load
    for name, s in zip(pt.names, state.ema["shadow"]):
        assert torch.equal(ours.model.state_dict()[name], s)
    w, n = ours.frontend_wave(wav_path)
    ids = ours.model_forward(w, n)
    assert ids == ref.model_forward(w, n)
    assert ours(wav_path) == ref(wav_path)
