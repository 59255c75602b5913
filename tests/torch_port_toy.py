"""The toy recipe's two train configs (``example/asr_toy/conf/config.yaml``:
``E2E_Transformer_CTC``; ``config_online.yaml``:
``E2E_Transformer_CTC_Online``) through the port's train CLI against the
JAX package's ``bin/train.py``, then the port's checkpoints through both
decode CLIs.  Shared by ``test_torch_port_toy_cli.py`` and
``test_torch_port_toy_online_cli.py``, one recipe each.

The recipe's model block and optimizer (Adam(0.9, 0.98) under its Noam
warmup) as they stand, with dropout and the sigmoid noise at 0 and no
SpecAugment (the two packages' draws cannot match), over a seeded corpus
of 8 train and 3 dev utterances of 0.5-0.9 s (test_torch_port_cli.py's
writer): 2 epochs of 2 steps, ``-ema 1``, both CLIs from lasr_tpu's
initial weights (the JAX CLI's own init, loaded into the port's model
before its Trainer starts).

  - ``-fp16 32``: every ``metrics.jsonl`` line (losses, ``att_corr``,
    ``ctc_cer``, ``grad_norm``, ``lr``, the validation losses) within
    1e-4, as ``test_torch_port_fit.py`` holds ``fit``;
  - ``-fp16 16``: the losses within 1e-2 relative, as
    ``test_torch_port_bf16.py`` holds the Conformer's CLI; the checkpoint
    all float32;
  - the port's checkpoints (``-choose last -avg 2``) decode to the same
    hypotheses and WER line through ``python -m
    lasr_tpu_torch.bin.decode`` and ``bin/decode.py``, with the recipe's
    decode settings (beam 5, ctc_beam 8, ctc_weight 0.5) and the recipe's
    method (``ctc_att``, online ``ctc_att_online``), and both packages'
    ``ASRProcess`` give the same result on the newest checkpoint file.
"""

import json
import os

import numpy as np
import torch
import yaml

from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.bin import train as port_train
from lasr_tpu_torch.data.reader import read_scp
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.train.trainer import Trainer
from lasr_tpu_torch.utils.weights import load_model_weights
from tests.test_torch_port_cli import (REPO, _decode_lines, _jax_cli,
                                       write_corpus)
from tests.torch_port_common import flax_state_dict

TOY = os.path.join(REPO, "example", "asr_toy", "conf")
CHAIN = ["norm", "fbank:80"]
NODROP = {"encoder_dropout_rate": 0.0, "decoder_dropout_rate": 0.0,
          "ctc_dropout": 0.0}
CORPUS = dict(n16=8, n8=0, secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
TOL = {32: dict(rtol=1e-4, atol=1e-4), 16: dict(rtol=1e-2, atol=0.0)}


def write_toy_config(tmp, recipe, train, valid):
    """The recipe's YAML with dropout and noise 0, no SpecAugment, and the
    data blocks pointed at the seeded corpora."""
    with open(os.path.join(TOY, f"{recipe}.yaml")) as f:
        cfg = yaml.safe_load(f)
    kw = cfg["model_config"]["kwargs"]
    kw.update(NODROP)
    if "Online" in cfg["model_config"]["name"]:
        kw["decoder_src_attention_sigmoid_noise"] = 0.0
    cfg["tokenizer_config"]["kwargs"]["dict_path"] = train[2]
    for key, corpus, bs in (("train_data_config", train, 4),
                            ("valid_data_config", valid, 3)):
        cfg[key]["kwargs"].update(wav_list=[corpus[0]], text_list=[corpus[1]],
                                  audio_trans=list(CHAIN), batch_size=bs)
    path = os.path.join(tmp, f"{recipe}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def _metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_and_decode(tmp_path, monkeypatch, capsys, recipe, fp16, method):
    train = write_corpus(str(tmp_path / "train"), seed=11, **CORPUS)
    valid = write_corpus(str(tmp_path / "dev"), seed=12,
                         **dict(CORPUS, n16=3))
    config = write_toy_config(str(tmp_path), recipe, train, valid)

    from lasr_tpu.train.trainer import Trainer as JaxTrainer
    init = {}
    jax_init = JaxTrainer.init_state

    def keep_init(self, sample):
        state = jax_init(self, sample)
        init["sd"] = flax_state_dict(state.params)
        return state
    monkeypatch.setattr(JaxTrainer, "init_state", keep_init)
    port_init = Trainer.init_state

    def load_init(self):
        load_model_weights(self.model, init["sd"])
        return port_init(self)
    monkeypatch.setattr(Trainer, "init_state", load_init)

    flags = ["-config", config, "-num_epochs", "2", "-fp16", str(fp16),
             "-ema", "1", "-log_interval", "1", "-num_workers", "1"]
    jexp, pexp = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _jax_cli("train").main(flags + ["-exp_dir", jexp,
                                           "-num_devices", "1",
                                           "-fast_rng", "0"]) == 0
    assert port_train.main(flags + ["-exp_dir", pexp,
                                    "-device", "cpu"]) == 0
    want, got = _metrics(jexp), _metrics(pexp)
    assert [(x["epoch"], x["step"]) for x in got] == \
        [(x["epoch"], x["step"]) for x in want] == \
        [(0, 1), (0, 2), (0, 2), (1, 3), (1, 4), (1, 4)]
    keys = ("loss_main", "att_loss", "ctc_loss", "valid_loss_main",
            "valid_att_loss", "valid_ctc_loss")
    if fp16 == 32:
        keys += ("att_corr", "ctc_cer", "grad_norm", "lr", "valid_att_corr",
                 "valid_ctc_cer")
    checked = 0
    for w, g in zip(want, got):
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], **TOL[fp16],
                                           err_msg=f"{k} step {w['step']}")
                checked += 1
    assert checked >= 12
    last = os.path.join(pexp, "checkpoints", "last")
    ckpt = torch.load(os.path.join(last, sorted(os.listdir(last))[-1]),
                      weights_only=False)
    assert all(x.dtype == torch.float32 for x in ckpt["state_dict"].values()
               if x.is_floating_point())

    with open(os.path.join(TOY, "decode.yaml")) as f:
        decode = yaml.safe_load(f)
    decode["decode_config"]["decode_method"] = method
    decode["test_data_config"]["kwargs"].update(
        wav_list=[valid[0]], text_list=[valid[1]], audio_trans=list(CHAIN))
    cfg = str(tmp_path / "decode.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(decode, f)
    capsys.readouterr()
    hparams = os.path.join(pexp, "hparams.yaml")
    root = os.path.join(pexp, "checkpoints")
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert port_decode.main(["-train_config", hparams, "-decode_config", cfg,
                             "-model_path", root, "-choose", "last",
                             "-avg", "2", "-output_file", ours,
                             "-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert _jax_cli("decode").main([
        "-train_config", hparams, "-decode_config", cfg,
        "-model_path", last, "-choose", "last", "-avg", "2",
        "-output_file", theirs]) == 0
    out_jax = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        got_text, want_text = f.read(), g.read()
    assert got_text == want_text and len(got_text.splitlines()) == 3
    assert _decode_lines(out_port) == _decode_lines(out_jax)

    # both ASRProcesses on the newest checkpoint file, the EMA shadow
    from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
    newest = os.path.join(last, sorted(os.listdir(last))[-1])
    wav = read_scp(valid[0])[0][1]
    port = ASRProcess(hparams, cfg, newest, device="cpu")
    assert port(wav) == JaxASRProcess(hparams, cfg, newest)(wav)
