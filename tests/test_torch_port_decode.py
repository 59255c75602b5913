"""Decode of the port vs lasr_tpu on identical weights: the joint
CTC/attention beam search token-exact (scores within 1e-4) at B=2 ragged,
beam 4, ctc_beam 5, and ASRProcess of both packages on one
reference-format checkpoint returning the same ids and text: for
ctc_att and ctc_greedy, and for every other decode method (ctc_att with
an RNNLM and nbest 2, long-form, ctc_bs with the RNNLM, ctc_kenlm_lexcoin
and wfst) on a checkpoint whose CTC head emits (``emitting_ctc_head``),
the LM written as orbax for lasr_tpu and as ``.pt`` for the port."""

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
from tests.torch_port_decoders import emitting_ctc_head, write_word_resources


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


@pytest.fixture(scope="module")
def methods_run(tmp_path_factory):
    """A tiny Conformer whose CTC head emits on a seeded wave of changing
    tones and whose decoder can end hypotheses, its hparams, a 10-word lexicon / ARPA / TLG over its letters,
    and an RNNLM as orbax (lasr_tpu) and ``.pt`` (the port)."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from lasr_tpu.modules.rnn import RNNCellStack
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.utils.weights import rnnlm_flax_to_state_dict
    root = tmp_path_factory.mktemp("methods")
    _, _, pm = model_pair(CONFIGS["B"], seed=6, idim=80)
    rng = np.random.default_rng(10)
    t = np.arange(1600) / 16000
    wav = np.concatenate([rng.uniform(0.05, 0.5) * np.sin(
        2 * np.pi * rng.uniform(100, 900) * t) for _ in range(20)])
    wav = wav + 0.02 * rng.standard_normal(wav.shape)
    write_wav(str(root / "x.wav"), wav, 16000)
    with torch.no_grad():
        x = torch.from_numpy(read_wav(str(root / "x.wav"))[0][None])
        feats, n = DeviceFrontend(["norm", "fbank:80"])(
            x, torch.tensor([x.shape[1]]))
        frames = pm.encode(feats, n, solo_pad=True)[0][0]
        w, b = emitting_ctc_head(frames, TINY["odim"])
        pm.ctc[1].weight.copy_(w)
        pm.ctc[1].bias.copy_(b)
        # random attention weights never rank eos among the candidates:
        # lift it, so that hypotheses end before the CTC prefixes run out
        # of frames
        pm.decoder.output_layer.bias[2] += 3.0
    torch.save(pm.state_dict(), root / "model.pt")
    (root / "dict.txt").write_text("A\nB\nC\n")
    with open(root / "hparams.yaml", "w") as f:
        yaml.safe_dump({
            "model_config": {
                "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
                "kwargs": dict(TINY, idim=80, **CONFIGS["B"])},
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": str(root / "dict.txt")}}}, f)
    kenlm, wfst = write_word_resources(
        str(root), {"A": 6, "B": 7, "C": 8},
        ["A", "B", "C", "AB", "BA", "CA", "AC", "CAB", "BAC", "ABC"])
    lm_kw = dict(input_dim=TINY["odim"], output_dim=TINY["odim"],
                 n_layers=2, n_units=16, typ="gru")
    params = jax.tree.map(np.asarray, RNNCellStack(**lm_kw).init(
        jax.random.PRNGKey(5), None, jnp.zeros((1,), jnp.int32))["params"])
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(root / "lm_orbax"), {"params": params})
    torch.save(rnnlm_flax_to_state_dict(params, "gru"), root / "lm.pt")
    lm = {"lm_rate": 0.3, "lm_config": {
        "name": "lasr_tpu.modules.rnn:RNNCellStack", "kwargs": lm_kw}}
    return dict(root=root, kenlm=kenlm, wfst=wfst, lm=lm)


METHODS = {
    "ctc_att_lm_nbest2": ("ctc_att", {"nbest": 2}, True),
    "longform": ("ctc_att", {"longform_segment_frames": 12,
                             "longform_encoder_window_frames": 8,
                             "longform_encoder_halo_frames": 3}, False),
    "ctc_bs_lm": ("ctc_bs", {}, True),
    "ctc_kenlm_lexcoin": ("ctc_kenlm_lexcoin", "kenlm", False),
    "wfst": ("wfst", "wfst", False),
}


@pytest.mark.parametrize("case", list(METHODS))
def test_asrprocess_decode_methods_match_jax(methods_run, case):
    root = methods_run["root"]
    method, keys, with_lm = METHODS[case]
    keys = dict(methods_run[keys] if isinstance(keys, str) else keys)
    for pkg, lm_path in (("port", root / "lm.pt"),
                         ("jax", root / "lm_orbax")):
        lm = dict(methods_run["lm"], lm_path=str(lm_path)) if with_lm \
            else {}
        with open(root / f"{case}_{pkg}.yaml", "w") as f:
            yaml.safe_dump({
                "decode_config": {"decode_method": method, "beam": 4,
                                  "ctc_beam": 5, "ctc_weight": 0.8,
                                  **keys, **lm},
                "test_data_config": {"kwargs": {
                    "audio_trans": ["norm", "fbank:80"]}}}, f)
    args = [str(root / "hparams.yaml"), None, str(root / "model.pt")]
    ours = ASRProcess(*args[:1], str(root / f"{case}_port.yaml"), args[2],
                      device="cpu")
    ref = JaxASRProcess(*args[:1], str(root / f"{case}_jax.yaml"), args[2])
    wav_path = str(root / "x.wav")
    got, want = ours(wav_path), ref(wav_path)
    assert got == want and got[1]


def test_greedy_collapses_repeats_then_blanks():
    logits = torch.full((1, 7, 4), -5.0)
    for i, tok in enumerate([0, 2, 2, 0, 2, 3, 3]):
        logits[0, i, tok] = 5.0
    assert ctc_greedy_decode(logits, torch.tensor([7])) == [[2, 2, 3]]
    assert ctc_greedy_decode(logits, torch.tensor([3])) == [[2]]
