"""The port's decode CLI and ``ASRProcess`` on the toy recipe's two models
(``example/asr_toy/conf/config.yaml``: ``E2E_Transformer_CTC``;
``config_online.yaml``: ``E2E_Transformer_CTC_Online``) against the JAX
package's ``bin/decode.py`` and ``ASRProcess``: seeded weights written as
one reference-format ``.pt``, the recipe's decode settings
(``decode.yaml``: beam 5, ctc_beam 8, ctc_weight 0.5) with ``ctc_att`` and
``ctc_att_online``, over a seeded corpus of three utterances.  Both CLIs
write the same hypotheses and WER line; both ``ASRProcess``es give the
CLI's row 0."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu.utils.registry import dynamic_import as jax_import
from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.data.reader import read_scp
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.utils.weights import flax_to_state_dict
from tests.test_torch_port_cli import _decode_lines, _jax_cli, write_corpus
from tests.torch_port_common import numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, "example", "asr_toy", "conf")
CHAIN = ["norm", "fbank:80"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    return root, write_corpus(str(root / "dev"), n16=3, n8=0, seed=31,
                              secs=(0.8, 1.6), n_words=(1, 3),
                              word_len=(1, 4))


def write_run(root, test, recipe, method, seed):
    """hparams.yaml of the toy recipe's model (odim from the corpus'
    dictionary), its seeded weights as model.pt (the JAX model's init,
    across the weight bridge), and a decode.yaml.  Returns the three
    paths."""
    with open(os.path.join(TOY, f"{recipe}.yaml")) as f:
        model_config = yaml.safe_load(f)["model_config"]
    with open(os.path.join(TOY, "decode.yaml")) as f:
        decode_config = yaml.safe_load(f)["decode_config"]
    model_config["kwargs"]["odim"] = CharTokenizer(test[2]).dict_size()
    fm = jax_import(model_config["name"])(**model_config["kwargs"])
    T = 100
    variables = numpy_tree(fm.init(
        jax.random.PRNGKey(seed), np.zeros((1, T, 80), np.float32),
        np.asarray([T], np.int32), np.ones((1, 3), np.int32)))
    run = os.path.join(str(root), f"{recipe}_{method}")
    os.makedirs(run, exist_ok=True)
    paths = [os.path.join(run, n) for n in ("hparams.yaml", "decode.yaml",
                                            "model.pt")]
    torch.save(flax_to_state_dict(variables), paths[2])
    with open(paths[0], "w") as f:
        yaml.safe_dump({
            "model_config": model_config,
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": test[2]}}}, f)
    with open(paths[1], "w") as f:
        yaml.safe_dump({
            "decode_config": dict(decode_config, decode_method=method),
            "test_data_config": {
                "name": "lasr_tpu.data.dataset:AudioDataSet",
                "kwargs": {"wav_list": [test[0]], "text_list": [test[1]],
                           "audio_trans": CHAIN}}}, f)
    return paths


@pytest.mark.parametrize("recipe,method", [
    ("config", "ctc_att"), ("config_online", "ctc_att_online"),
    ("config_online", "ctc_att")])
def test_decode_cli_and_asrprocess_match_jax(corpus, recipe, method,
                                             tmp_path, capsys):
    root, test = corpus
    hparams, decode_cfg, model = write_run(root, test, recipe, method,
                                           seed=len(recipe) + len(method))
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert port_decode.main(["-train_config", hparams, "-decode_config",
                             decode_cfg, "-model_path", model,
                             "-output_file", ours, "-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert _jax_cli("decode").main([
        "-train_config", hparams, "-decode_config", decode_cfg,
        "-model_path", model, "-output_file", theirs]) == 0
    out_jax = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        got, want = f.read(), g.read()
    assert got == want and len(got.splitlines()) == 3
    assert _decode_lines(out_port) == _decode_lines(out_jax)

    uid, wav = read_scp(test[0])[0]
    ref = JaxASRProcess(hparams, decode_cfg, model)
    port = ASRProcess(hparams, decode_cfg, model, device="cpu")
    _, text = port(wav)
    assert port(wav) == ref(wav)
    assert got.splitlines()[0] == f"{text} ({uid})"
