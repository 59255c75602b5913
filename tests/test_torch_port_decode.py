"""Decode of the port vs lasr_tpu on identical weights: the joint
CTC/attention beam search token-exact (scores within 1e-4) at B=2 ragged,
beam 4, ctc_beam 5, and ASRProcess of both packages on one
reference-format checkpoint returning the same ids and text."""

import numpy as np
import pytest
import torch
import yaml

from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu_torch.data.reader import read_wav, write_wav
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder, _top_k
from lasr_tpu_torch.decode.greedy import ctc_greedy_decode
from lasr_tpu_torch.process.asrprocess import ASRProcess
from tests.torch_port_common import CONFIGS, TINY, model_pair


@pytest.mark.parametrize("seed,config", [(0, "A"), (1, "B")])
def test_beam_search_token_exact(seed, config):
    fm, variables, pm = model_pair(CONFIGS[config], seed=seed)
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((2, 61, 20)).astype(np.float32)
    xlen = np.asarray([61, 43], np.int32)
    kw = dict(beam=4, ctc_beam=5, ctc_weight=0.5, nbest=3)
    want = JaxBeam(fm, variables, **kw)(x, xlen)
    got = CTCAttBeamDecoder(pm, device="cpu", **kw)(x, xlen)
    for b in range(2):
        assert got.best_ids(b) == want.best_ids(b)
        w_nb, g_nb = want.nbest_ids(b), got.nbest_ids(b)
        assert [ids for ids, _ in g_nb] == [ids for ids, _ in w_nb]
        np.testing.assert_allclose([s for _, s in g_nb],
                                   [s for _, s in w_nb], atol=1e-4)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e10, 3.0, -1e10]])
    vals, idx = _top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]


def test_asrprocess_same_ids_and_text_as_jax(tmp_path):
    kw = dict(TINY, idim=80)
    _, _, pm = model_pair(CONFIGS["A"], seed=4, idim=80)
    torch.save(pm.state_dict(), tmp_path / "model.pt")
    (tmp_path / "dict.txt").write_text("A\nB\nC\n")
    with open(tmp_path / "hparams.yaml", "w") as f:
        yaml.safe_dump({
            "model_config": {
                "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
                "kwargs": dict(kw, **CONFIGS["A"])},
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": str(tmp_path / "dict.txt")}}}, f)
    for method in ("ctc_att", "ctc_greedy"):
        with open(tmp_path / f"{method}.yaml", "w") as f:
            yaml.safe_dump({
                "decode_config": {"decode_method": method, "beam": 4,
                                  "ctc_beam": 5, "ctc_weight": 0.5,
                                  "lm_rate": 0},
                "test_data_config": {"kwargs": {
                    "audio_trans": ["norm", "fbank:80"]}}}, f)
    rng = np.random.default_rng(9)
    n = 24000
    wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000) \
        + 0.05 * rng.standard_normal(n)
    wav_path = str(tmp_path / "x.wav")
    write_wav(wav_path, wav, 16000)
    assert read_wav(wav_path)[0].shape == (n,)

    for method in ("ctc_att", "ctc_greedy"):
        args = (str(tmp_path / "hparams.yaml"),
                str(tmp_path / f"{method}.yaml"), str(tmp_path / "model.pt"))
        ours = ASRProcess(*args, device="cpu")
        ref = JaxASRProcess(*args)
        w, m = ours.frontend_wave(wav_path)
        assert ours.model_forward(w, m) == ref.model_forward(w, m)
        assert ours(wav_path) == ref(wav_path)


def test_greedy_collapses_repeats_then_blanks():
    logits = torch.full((1, 7, 4), -5.0)
    for i, tok in enumerate([0, 2, 2, 0, 2, 3, 3]):
        logits[0, i, tok] = 5.0
    assert ctc_greedy_decode(logits, torch.tensor([7])) == [[2, 2, 3]]
    assert ctc_greedy_decode(logits, torch.tensor([3])) == [[2]]
