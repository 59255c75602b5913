"""The port's train and decode CLIs (``lasr_tpu_torch.bin.train``,
``lasr_tpu_torch.bin.decode``) on the CPU, against the JAX package's
``bin/train.py`` and ``bin/decode.py`` (run in this process through their
``main(argv)``), on a seeded corpus the test writes and a tiny Conformer:

  - the train CLI trains 2 epochs, validates and writes ``hparams.yaml``,
    ``metrics.jsonl`` and ``checkpoints/{last,best}``; its
    ``hparams.yaml`` equals the JAX CLI's for the same YAML;
  - the port's decode CLI on the checkpoints root and the JAX CLI on its
    ``last/`` directory (a directory of ``.ckpt`` files) give the same
    hypotheses and the same ``Totol WER`` line for every decode method:
    ``ctc_att`` (also with an RNNLM and nbest 2: the same ``.nbest``
    lists, scores within 1e-3; and long-form, windowed and segmented), ``ctc_greedy``,
    ``ctc_bs`` (with the RNNLM), ``ctc_kenlm``, ``ctc_kenlm_lexcoin`` and
    ``wfst`` (a lexicon, ARPA and TLG built here), on a checkpoint
    whose CTC head is made to emit letters (``write_emitting_checkpoint``).
    The LM is written twice from one set of weights: orbax for
    ``lasr_tpu``, ``.pt`` for the port; the port's decode with the orbax
    LM equals its decode with the ``.pt`` one;
  - the train CLI's ``-seq_parallel`` and ``-pipeline_parallel`` train on
    2 ``gloo`` ranks.

This module imports no JAX at its top (the JAX CLIs load inside the
tests): its corpus and config writers serve the card's tests too.
"""

import importlib.util
import json
import os
import re
import shutil

import numpy as np
import pytest
import yaml

from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.bin import train as port_train
from lasr_tpu_torch.data.reader import write_wav
from lasr_tpu_torch.utils.weights import checkpoint_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LETTERS = "ABCDEFGH"
TINY_CONFORMER = dict(
    idim=20, odim=0, encoder_attention_dim=16, encoder_attention_heads=2,
    encoder_linear_units=32, encoder_num_blocks=2, decoder_attention_dim=16,
    decoder_attention_heads=2, decoder_linear_units=32, decoder_num_block=2,
    encoder_pos_enc_layer_type="rel_pos",
    encoder_selfattention_layer_type="rel_selfattn", encoder_cnn_kernel=7)
CHAIN = ["norm", "fbank:20"]


def write_corpus(root, n16=16, n8=2, seed=0, secs=(0.5, 1.6),
                 n_words=(1, 4), word_len=(1, 5)):
    """A seeded wav.scp / text pair under ``root``: ``n16`` WAVs at 16 kHz
    then ``n8`` at 8 kHz of ``secs`` seconds (a tone under noise),
    transcripts of ``n_words`` words of ``word_len`` letters (upper bounds
    exclusive), and a CharTokenizer dictionary of LETTERS and the space.
    Returns (wav.scp, text, dict)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scp, txt = os.path.join(root, "wav.scp"), os.path.join(root, "text")
    with open(scp, "w") as ws, open(txt, "w") as tx:
        for i in range(n16 + n8):
            rate = 16000 if i < n16 else 8000
            uid = f"utt{i:03d}"
            n = int(rng.uniform(*secs) * rate)
            t = np.arange(n) / rate
            w = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
                + 0.05 * rng.standard_normal(n)
            path = os.path.join(root, f"{uid}.wav")
            write_wav(path, w, rate)
            ws.write(f"{uid} {path}\n")
            words = ["".join(rng.choice(list(LETTERS),
                                        rng.integers(*word_len)))
                     for _ in range(rng.integers(*n_words))]
            tx.write(f"{uid} {' '.join(words).lower()}\n")
    dict_path = os.path.join(root, "dict.txt")
    with open(dict_path, "w") as f:
        f.write("\n".join(list(LETTERS) + [" "]) + "\n")
    return scp, txt, dict_path


def write_config(path, train, valid, model_kwargs, chain=CHAIN,
                 train_batch=4, valid_batch=3, warm_step=10):
    """A train YAML in the recipes' schema naming the JAX package's
    classes, over the corpora ``train`` / ``valid`` (``write_corpus``
    results), Adam under a Noam warmup of ``warm_step`` steps."""
    def data(corpus, batch_size):
        return {"name": "lasr_tpu.data.dataset:BatchAudioDataSet",
                "kwargs": {"wav_list": [corpus[0]], "text_list": [corpus[1]],
                           "audio_trans": list(chain), "pad_audio": 0,
                           "pad_feats": 0, "batch_size": batch_size,
                           "batch_type": "size", "min_duration": 0,
                           "text_freq": 0}}
    config = {
        "model_config": {
            "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
            "kwargs": dict(model_kwargs)},
        "opti_config": {
            "name": "lasr_tpu.train.optimizer:Adam",
            "kwargs": {"betas": [0.9, 0.98]},
            "scheduler": {
                "name": "lasr_tpu.train.optimizer:WarmupScheduler",
                "kwargs": {"factor": 1, "warm_step": warm_step,
                           "model_size": 16, "offset": 0}}},
        "criterion_config": {
            "name": "lasr_tpu.models.losses:E2E_Loss",
            "kwargs": {"size": 0, "padding_idx": -1, "smoothing": 0.1,
                       "rate": 0.3}},
        "tokenizer_config": {
            "name": "lasr_tpu.data.tokenizer:CharTokenizer",
            "kwargs": {"dict_path": train[2]}},
        "train_data_config": data(train, train_batch),
        "valid_data_config": data(valid, valid_batch)}
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return path


def write_decode_config(path, test, method, chain=CHAIN, **keys):
    """A decode YAML over the corpus ``test``; ``keys`` add to (or
    replace) its decode_config."""
    with open(path, "w") as f:
        yaml.safe_dump({
            "decode_config": {"decode_method": method, "beam": 3,
                              "ctc_beam": 4, "ctc_weight": 0.5,
                              "lm_path": None, "lm_rate": 0, **keys},
            "test_data_config": {
                "name": "lasr_tpu.data.dataset:AudioDataSet",
                "kwargs": {"wav_list": [test[0]], "text_list": [test[1]],
                           "audio_trans": list(chain)}}}, f)
    return path


def _jax_cli(name):
    """The JAX package's ``bin/<name>.py`` as a module (it imports JAX)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_bin_{name}", os.path.join(REPO, "bin", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A corpus, its config, and 2 epochs of the port's train CLI."""
    root = tmp_path_factory.mktemp("cli")
    train = write_corpus(str(root / "train"), n16=8, n8=0, seed=11,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    valid = write_corpus(str(root / "dev"), n16=3, n8=0, seed=12,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    config = write_config(str(root / "config.yaml"), train, valid,
                          TINY_CONFORMER)
    exp = str(root / "exp")
    assert port_train.main(["-config", config, "-exp_dir", exp,
                            "-num_epochs", "2", "-ema", "1",
                            "-log_interval", "1", "-num_workers", "2",
                            "-device", "cpu"]) == 0
    return dict(root=root, train=train, valid=valid, config=config, exp=exp)


def test_train_cli_writes_the_run(run, tmp_path):
    exp = run["exp"]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    # 8 utterances in batches of 4: 2 steps an epoch, each flushed, then
    # the epoch's validation line
    assert [(x["epoch"], x["step"], "valid_loss_main" in x)
            for x in lines] == [(0, 1, False), (0, 2, False), (0, 2, True),
                                (1, 3, False), (1, 4, False), (1, 4, True)]
    for x in lines:
        assert all(np.isfinite(v) for k, v in x.items()
                   if isinstance(v, float))
        if "valid_loss_main" not in x:
            assert {"loss_main", "att_loss", "ctc_loss", "grad_norm", "lr",
                    "data_wait_s", "dispatch_s", "utts_cum"} <= set(x)
    root = os.path.join(exp, "checkpoints")
    assert sorted(checkpoint_steps(os.path.join(root, "last"))) == [2, 4]
    assert sorted(checkpoint_steps(os.path.join(root, "best"))) == [2, 4]
    with open(os.path.join(root, "loop_state.json")) as f:
        assert json.load(f) == {"2": [1, 0], "4": [2, 0]}
    with open(os.path.join(exp, "hparams.yaml")) as f:
        hparams = yaml.safe_load(f)
    assert list(hparams) == ["model_config", "criterion_config",
                             "optim_config", "tokenizer_config"]
    assert hparams["model_config"]["name"] == \
        "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC"
    assert hparams["model_config"]["kwargs"]["odim"] == 15
    assert hparams["criterion_config"]["kwargs"]["size"] == 15
    # a second call in (a copy of) the run continues from the newest
    # checkpoint: one more epoch
    again = str(tmp_path / "again")
    shutil.copytree(exp, again)
    assert port_train.main(["-config", run["config"], "-exp_dir", again,
                            "-num_epochs", "3", "-ema", "1",
                            "-log_interval", "1", "-device", "cpu"]) == 0
    assert sorted(checkpoint_steps(
        os.path.join(again, "checkpoints", "last"))) == [2, 4, 6]


def test_hparams_equal_the_jax_cli(run, tmp_path):
    jax_train = _jax_cli("train")
    exp = str(tmp_path / "jax")
    assert jax_train.main(["-config", run["config"], "-exp_dir", exp,
                           "-num_epochs", "0", "-num_devices", "1",
                           "-fast_rng", "0"]) == 0
    with open(os.path.join(exp, "hparams.yaml")) as f:
        want = f.read()
    with open(os.path.join(run["exp"], "hparams.yaml")) as f:
        assert f.read() == want


def _decode_lines(out):
    """(hypothesis lines of each utterance, the WER line) of a CLI's
    stdout."""
    hyps = re.findall(r"^id (\S+)\nref: (.*)\nhyp: (.*)\ndis: (\d+)$", out,
                      flags=re.M)
    wer = [line for line in out.splitlines() if line.startswith("Totol")]
    return hyps, wer


def write_emitting_checkpoint(run, root):
    """The run's last checkpoint (2 averaged) with the CTC head of
    ``emitting_ctc_head`` over the dev set's encoder frames (2 epochs
    leave blank first on every frame), as
    ``root/last/step-000000001.ckpt``; returns ``root``."""
    import torch
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.data.reader import read_scp, read_wav
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    from lasr_tpu_torch.utils.weights import (load_model_weights,
                                              load_reference_checkpoint)
    from tests.torch_port_decoders import emitting_ctc_head
    sd = dict(load_reference_checkpoint(
        os.path.join(run["exp"], "checkpoints"), "last", 2))
    model = E2E_Conformer_CTC(**dict(TINY_CONFORMER, odim=15), device="cpu")
    load_model_weights(model, sd)
    frontend = DeviceFrontend(CHAIN)
    frames = []
    with torch.no_grad():
        for _, path in read_scp(run["valid"][0]):
            wav = torch.from_numpy(read_wav(path)[0][None])
            feats, n = frontend(wav, torch.tensor([wav.shape[1]]))
            frames.append(model.encode(feats, n, solo_pad=True)[0][0])
    sd["ctc.1.weight"], sd["ctc.1.bias"] = emitting_ctc_head(
        torch.cat(frames), 15)
    os.makedirs(os.path.join(root, "last"))
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
               os.path.join(root, "last", "step-000000001.ckpt"))
    return root


@pytest.fixture(scope="module")
def decoders(run, tmp_path_factory):
    """The resources of the word-level decoders and an RNNLM over the
    run's vocabulary, written for each package: its flax weights as an
    orbax checkpoint (``lasr_tpu``) and as a ``.pt`` state_dict (the
    port)."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch
    from lasr_tpu.modules.rnn import RNNCellStack
    from lasr_tpu_torch.data.tokenizer import CharTokenizer
    from lasr_tpu_torch.utils.weights import rnnlm_flax_to_state_dict
    from tests.torch_port_decoders import write_word_resources

    root = tmp_path_factory.mktemp("decoders")
    tok = CharTokenizer(run["valid"][2])
    with open(run["valid"][1]) as f:
        words = sorted({w.upper() for line in f
                        for w in line.split()[1:]}
                   | set(LETTERS) | {"AF", "FA", "AH", "HEAD"})
    chars = {c: tok.char_list.index(c) for c in LETTERS}
    kenlm, wfst = write_word_resources(str(root), chars, words,
                                       space_id=tok.char_list.index(" "))
    V = len(tok.char_list)
    lm_kw = dict(input_dim=V, output_dim=V, n_layers=1, n_units=16)
    params = jax.tree.map(np.asarray, RNNCellStack(**lm_kw).init(
        jax.random.PRNGKey(3), None, jnp.zeros((1,), jnp.int32))["params"])
    orbax_dir = str(root / "lm_orbax")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(orbax_dir, {"params": params})
    torch.save(rnnlm_flax_to_state_dict(params), str(root / "lm.pt"))
    lm = {"lm_rate": 0.3, "lm_config": {
        "name": "lasr_tpu.modules.rnn:RNNCellStack", "kwargs": lm_kw}}
    return dict(kenlm=kenlm, wfst=wfst, lm=lm, orbax=orbax_dir,
                pt=str(root / "lm.pt"),
                ckpts=write_emitting_checkpoint(run, str(root / "ckpts")))


# decode-config keys of each case beyond the method: "lm" adds the RNNLM
DECODE_CASES = {
    "ctc_att": ("ctc_att", {}),
    "ctc_greedy": ("ctc_greedy", {}),
    "ctc_att_lm_nbest2": ("ctc_att", {"lm": True, "nbest": 2}),
    "longform": ("ctc_att", {"longform_segment_frames": 4,
                             "longform_encoder_window_frames": 4,
                             "longform_encoder_halo_frames": 2}),
    "ctc_bs_lm": ("ctc_bs", {"lm": True}),
    "ctc_kenlm": ("ctc_kenlm", {"kenlm": True}),
    "ctc_kenlm_lexcoin": ("ctc_kenlm_lexcoin", {"kenlm": True}),
    "wfst": ("wfst", {"wfst": True}),
}


def _case_keys(case, decoders, lm_path):
    method, extra = DECODE_CASES[case]
    keys = {k: v for k, v in extra.items()
            if k not in ("lm", "kenlm", "wfst")}
    if extra.get("lm"):
        keys.update(decoders["lm"], lm_path=lm_path)
    for k in ("kenlm", "wfst"):
        if extra.get(k):
            keys.update(decoders[k])
    return method, keys


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_cli_matches_the_jax_cli(run, decoders, case, tmp_path,
                                        capsys):
    valid = run["valid"]
    method, keys = _case_keys(case, decoders, decoders["pt"])
    cfg = write_decode_config(str(tmp_path / "decode.yaml"), valid, method,
                              **keys)
    method, keys = _case_keys(case, decoders, decoders["orbax"])
    cfg_jax = write_decode_config(str(tmp_path / "decode_jax.yaml"), valid,
                                  method, **keys)
    hparams = os.path.join(run["exp"], "hparams.yaml")
    root = decoders["ckpts"]
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert port_decode.main(["-train_config", hparams, "-decode_config", cfg,
                             "-model_path", root, "-choose", "last",
                             "-avg", "2", "-output_file", ours,
                             "-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert _jax_cli("decode").main([
        "-train_config", hparams, "-decode_config", cfg_jax,
        "-model_path", os.path.join(root, "last"), "-choose", "last",
        "-avg", "2", "-output_file", theirs]) == 0
    out_jax = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        got, want = f.read(), g.read()
    assert got == want and len(got.splitlines()) == 3
    hyps, wer = _decode_lines(out_port)
    assert (hyps, wer) == _decode_lines(out_jax)
    assert len(hyps) == 3 and len(wer) == 1
    rtf = json.loads(out_port.strip().splitlines()[-1])
    assert rtf["decode_batches"] == 1 and rtf["audio_total_s"] > 0
    nbest = keys.get("nbest", 1) > 1
    assert os.path.exists(ours + ".nbest") == nbest
    if nbest:
        # "{id}-{rank} {score:.4f} {text}": ids, ranks and texts equal,
        # scores within 1e-3 (the packages' scores differ by ~1e-5, which
        # can move the fourth decimal)
        got, want = (_nbest_lines(path + ".nbest") for path in (ours, theirs))
        assert len(got) == 6
        assert [(k, t) for k, _, t in got] == [(k, t) for k, _, t in want]
        np.testing.assert_allclose([sc for _, sc, _ in got],
                                   [sc for _, sc, _ in want], atol=1e-3)


def _nbest_lines(path):
    """(utterance-rank, score, text) of each line of a ``.nbest`` file."""
    with open(path) as f:
        rows = [line.rstrip("\n").split(" ", 2) for line in f]
    return [(k, float(sc), text) for k, sc, text in rows]


GRID_FLAGS = [("-seq_parallel", "2"), ("-pipeline_parallel", "2")]


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """The train CLI started once for each of GRID_FLAGS, the runs side
    by side: {flag: (exit code, output, exp_dir)}."""
    from tests.torch_port_dp_worker import Worker
    tmp = tmp_path_factory.mktemp("grid")
    train = write_corpus(str(tmp / "train"), n16=4, n8=0, seed=33,
                         secs=(0.5, 0.8), n_words=(1, 3), word_len=(1, 4))
    valid = write_corpus(str(tmp / "dev"), n16=2, n8=0, seed=34,
                         secs=(0.5, 0.8), n_words=(1, 3), word_len=(1, 4))
    config = write_config(str(tmp / "config.yaml"), train, valid,
                          TINY_CONFORMER, train_batch=4, valid_batch=2)
    workers = {}
    for flag, value in GRID_FLAGS:
        exp = str(tmp / flag.lstrip("-"))
        workers[flag] = (exp, Worker(
            ["-config", config, "-exp_dir", exp, "-num_epochs", "1",
             "-log_interval", "1", "-num_workers", "1", "-device", "cpu",
             flag, value], str(tmp), module="lasr_tpu_torch.bin.train",
            name=flag.lstrip("-")))
    return {flag: w.wait() + (exp,) for flag, (exp, w) in workers.items()}


@pytest.mark.parametrize("flag,value", GRID_FLAGS)
def test_train_cli_refuses_unported_flags(flag, value, grid_runs):
    """Once refused, now the grid's seq and pipe axes: the train CLI runs
    an epoch on 2 ``gloo`` ranks, rank 0 writes one checkpoint tree (the
    pipelined run's ``hparams.yaml`` naming its 2 stages) whose weights a
    one-process model loads."""
    rc, out, exp = grid_runs[flag]
    assert rc == 0, out[-6000:]
    pipe = int(flag == "-pipeline_parallel")
    assert "world size 2" in out and \
        f"{1 + pipe} pipe x {2 - pipe} seq ranks" in out
    with open(os.path.join(exp, "hparams.yaml")) as f:
        kwargs = yaml.safe_load(f)["model_config"]["kwargs"]
    assert kwargs.get("encoder_pipeline_stages", 1) == 1 + pipe
    last = os.path.join(exp, "checkpoints", "last")
    (name,) = checkpoint_steps(last).values()
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    from lasr_tpu_torch.utils.weights import (load_model_weights,
                                              load_reference_checkpoint)
    model = E2E_Conformer_CTC(**kwargs, device="cpu")
    load_model_weights(model, load_reference_checkpoint(
        os.path.join(last, name)))


def test_decode_cli_refuses_an_orbax_lm(run, decoders, tmp_path, capsys):
    """Once a refusal, now the other way: the orbax LM directory that
    ``lasr_tpu`` reads decodes (ctc_att, the RNNLM, nbest 2) exactly as
    the ``.pt`` LM written from the same weights."""
    outs = {}
    for name in ("orbax", "pt"):
        cfg = write_decode_config(str(tmp_path / f"{name}.yaml"),
                                  run["valid"], "ctc_att",
                                  lm_path=decoders[name], nbest=2,
                                  **decoders["lm"])
        out = str(tmp_path / f"{name}.txt")
        assert port_decode.main([
            "-train_config", os.path.join(run["exp"], "hparams.yaml"),
            "-decode_config", cfg, "-model_path", decoders["ckpts"],
            "-choose", "last", "-output_file", out, "-device", "cpu"]) == 0
        with open(out) as f, open(out + ".nbest") as g:
            outs[name] = (f.read(), g.read(),
                          _decode_lines(capsys.readouterr().out))
    assert outs["orbax"] == outs["pt"]
    assert len(outs["pt"][0].splitlines()) == 3
