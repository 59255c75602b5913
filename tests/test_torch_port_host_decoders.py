"""The port's host-side decoders (its copies of ``lasr_tpu``'s
``ctc_bs``, ``ngram_lm``, ``ctc_w2l`` and ``wfst``, and of
``tools/build_tlg.py``'s TLG builder) against ``lasr_tpu``'s on the same
numpy inputs, over the JAX tests' own fixture cases
(``tests/test_wordlm_decoders.py``, ``tests/test_wfst_binary.py``):
exactly equal results, except ``ctc_bs`` with an RNNLM, whose two LMs
agree within 2e-5: its prefixes exact, its scores within 1e-4."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.decode.ctc_bs as jax_ctc_bs
import lasr_tpu.decode.ctc_w2l as jax_w2l
import lasr_tpu.decode.ngram_lm as jax_ngram
import lasr_tpu.decode.wfst as jax_wfst
import lasr_tpu_torch.decode.ctc_bs as port_ctc_bs
import lasr_tpu_torch.decode.ctc_w2l as port_w2l
import lasr_tpu_torch.decode.ngram_lm as port_ngram
import lasr_tpu_torch.decode.wfst as port_wfst
from lasr_tpu.modules.rnn import RNNLM as JaxRNNLM
from lasr_tpu.modules.rnn import RNNCellStack as JaxRNNCellStack
from lasr_tpu_torch.modules.rnn import RNNLM, RNNCellStack
from lasr_tpu_torch.utils.weights import rnnlm_flax_to_state_dict
from tests.test_wfst_binary import (FINALS, GRAPH, N_STATES, START,
                                    write_const_fst, write_text_fst,
                                    write_vector_fst)
from tests.test_wordlm_decoders import ARPA

PACKAGES = {"jax": (jax_ngram, jax_w2l, jax_wfst, jax_ctc_bs),
            "port": (port_ngram, port_w2l, port_wfst, port_ctc_bs)}


def log_softmax(logits):
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def planted(rng, plant, V, boost=4.0):
    logits = rng.standard_normal((len(plant), V))
    for t, k in enumerate(plant):
        logits[t, k] += boost
    return log_softmax(logits)


def arpa_backoff(pkg, tmp_path):
    ngram = pkg[0]
    lm = ngram.ArpaNgramLM(str(tmp_path / "lm.arpa"))
    out, st = [], lm.start()
    for w in ["hello", "world", "hello", "zebra", "world", "hello"]:
        st, s = lm.score_word(st, w)
        out.append((st, s))
    return (out, lm.finish(st), lm.sentence_logprob(["hello", "world"]),
            ngram.read_dict(str(tmp_path / "tokens.txt"), eos="<eos>"))


def _lexicon_decoder(pkg, tmp_path, **kw):
    kw.setdefault("beam_size", 64)
    kw.setdefault("beam_threshold", 1e9)
    return pkg[1].CTC_KenLM_Decoder(
        lexicon=str(tmp_path / "lexicon.txt"),
        tokens_dict=str(tmp_path / "tokens.txt"),
        kenlm_model=str(tmp_path / "lm.arpa"), **kw)


def lexicon_planted(pkg, tmp_path):
    dec = _lexicon_decoder(pkg, tmp_path, lm_weight=1.5, word_score=-0.5)
    lp = planted(np.random.default_rng(0), [1, 0, 2, 0, 2, 3, 0], 5)
    pruned = _lexicon_decoder(pkg, tmp_path, lm_weight=1.5, word_score=-0.5,
                              beam_size_token=2)
    return dec.decode_problike(lp), dec.decode_words(lp), \
        pruned.decode_problike(lp)


def lexicon_random(pkg, tmp_path):
    dec = _lexicon_decoder(pkg, tmp_path, lm_weight=2.0, word_score=-1.0,
                           beam_size=8, log_add=True)
    rng = np.random.default_rng(7)
    return [dec.decode_problike(log_softmax(2.0 * rng.standard_normal(
        (9, 5)))) for _ in range(5)]


def wfst_graphs(pkg, tmp_path):
    """The oracle graph (planted and random posteriors, an ilabel map) and
    the epsilon graph of test_wordlm_decoders.py."""
    wfst = pkg[2]
    g, w = str(tmp_path / "g.fst.txt"), str(tmp_path / "words.txt")
    out = []
    rng = np.random.default_rng(3)
    for scale, mdl in ((0.7, None), (0.4, None),
                       (0.7, str(tmp_path / "map.txt"))):
        dec = wfst.Kaldi_Decoder(beam=100.0, max_active=100, mdl=mdl, fst=g,
                                 word=w, acoustic_scale=scale)
        out += [dec.decode_loglike(2.0 * rng.standard_normal((5, 3)))
                for _ in range(3)]
    dec = wfst.Kaldi_Decoder(beam=10.0, max_active=10, mdl=None,
                             fst=str(tmp_path / "e.fst.txt"), word=w,
                             acoustic_scale=1.0)
    ll = np.zeros((1, 3))
    ll[0, 1] = 1.5
    return out + [dec.decode_loglike(ll)]


def wfst_binary_formats(pkg, tmp_path):
    """test_wfst_binary.py's graph as text, vector and const (aligned and
    not) binaries, and through the library writer."""
    wfst = pkg[2]
    write_text_fst(tmp_path / "b.txt", START, GRAPH, FINALS)
    write_vector_fst(tmp_path / "b_v.fst", START, N_STATES, GRAPH, FINALS)
    write_const_fst(tmp_path / "b_c.fst", START, N_STATES, GRAPH, FINALS)
    write_const_fst(tmp_path / "b_u.fst", START, N_STATES, GRAPH, FINALS,
                    aligned=False)
    by_src = {s: list(a) for s, a in GRAPH.items() if a}
    lib = tmp_path / f"b_lib_{pkg[2].__name__.split('.')[0]}.fst"
    wfst.StdFst.from_parts(START, by_src, FINALS).write_binary(str(lib))
    (tmp_path / "bw.txt").write_text(
        "<eps> 0\nhello 10\nagain 11\nwide 20\nworld 30\nword 31\n")
    out = [lib.read_bytes()]
    ll = np.random.default_rng(7).standard_normal((3, 4))
    for name in ("b.txt", "b_v.fst", "b_c.fst", "b_u.fst", lib.name):
        dec = wfst.Kaldi_Decoder(beam=100.0, max_active=100, mdl=None,
                                 fst=str(tmp_path / name),
                                 word=str(tmp_path / "bw.txt"),
                                 acoustic_scale=1.0)
        fst = dec.fst
        out.append((fst.start, fst.arcs, fst.finals, dec.decode_loglike(ll)))
    return out


def tlg(pkg, tmp_path):
    """The TLG builder's text and binary graphs (the same bytes from both
    packages) and their decodes."""
    ngram, _, wfst, _ = pkg
    tag = wfst.__name__.split(".")[0]
    if tag == "lasr_tpu":
        sys.path.insert(0, "tools")
        from build_tlg import write_tlg
    else:
        write_tlg = wfst.write_tlg
    lm = ngram.ArpaNgramLM(str(tmp_path / "lm.arpa"))
    lex = {"hello": [0, 1], "world": [1, 2]}
    out = []
    for binary in (False, True):
        path = tmp_path / f"tlg_{tag}_{binary}"
        out.append(write_tlg(str(path), str(tmp_path / f"w_{tag}.txt"), lex,
                             lm, n_tokens=3, binary=binary))
        out.append(path.read_bytes())
        dec = wfst.Kaldi_Decoder(beam=1e9, max_active=10**6, mdl=None,
                                 fst=str(path),
                                 word=str(tmp_path / f"w_{tag}.txt"),
                                 acoustic_scale=1.0)
        ll = np.log(np.random.default_rng(3).dirichlet(np.ones(4), size=12))
        out.append(dec.decode_loglike(ll))
    return out


def ctc_bs(pkg, tmp_path):
    dec = pkg[3].CTC_Decoder(beam_size=4, ctc_beam=3, sos=1)
    rng = np.random.default_rng(11)
    return [dec.decode_problike(log_softmax(3.0 * rng.standard_normal(
        (12, 7)))) for _ in range(3)] + [dec.decode_problike(
            np.exp(log_softmax(rng.standard_normal((6, 7)))), do_log=True)]


CASES = {"arpa_backoff": arpa_backoff, "lexicon_planted": lexicon_planted,
         "lexicon_random": lexicon_random, "wfst_graphs": wfst_graphs,
         "wfst_binary_formats": wfst_binary_formats, "tlg": tlg,
         "ctc_bs": ctc_bs}


def write_fixtures(tmp_path):
    (tmp_path / "lm.arpa").write_text(ARPA)
    (tmp_path / "lexicon.txt").write_text("hello a b\nworld b c\n")
    (tmp_path / "tokens.txt").write_text("a 1\nb 2\nc 3\n")
    (tmp_path / "g.fst.txt").write_text(
        "0 0 1 0 0.0\n0 1 2 10 0.5\n1 1 1 0 0.0\n1 1 2 0 0.0\n"
        "1 2 3 0 0.0\n0 3 3 11 0.1\n3 3 1 0 0.0\n3 2 2 0 0.3\n"
        "2 2 1 0 0.0\n2 0.2\n")
    (tmp_path / "e.fst.txt").write_text(
        "0 1 2 10 0.0\n1 2 0 11 0.25\n2 0.0\n")
    (tmp_path / "words.txt").write_text("<eps> 0\nhello 10\nworld 11\n")
    (tmp_path / "map.txt").write_text("1 2\n2 0\n3 1\n")


@pytest.mark.parametrize("case", list(CASES))
def test_host_decoder_equals_jax(case, tmp_path):
    write_fixtures(tmp_path)
    want = CASES[case](PACKAGES["jax"], tmp_path)
    got = CASES[case](PACKAGES["port"], tmp_path)
    assert got == want


def test_ctc_bs_with_rnnlm_matches_jax():
    V = 7
    kw = dict(input_dim=V, output_dim=V, n_layers=2, n_units=12)
    fm = JaxRNNCellStack(**kw)
    v = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(2), None,
                                         jnp.zeros((1,), jnp.int32)))
    pm = RNNCellStack(**kw, device="cpu")
    pm.load_state_dict(rnnlm_flax_to_state_dict(v))
    lp = log_softmax(2.0 * np.random.default_rng(13).standard_normal((10, V)))
    want = jax_ctc_bs.CTC_Decoder(
        beam_size=4, ctc_beam=4, sos=1, rnn_lm=JaxRNNLM(fm, v),
        lm_rate=0.5).decode_problike(lp)
    got = port_ctc_bs.CTC_Decoder(
        beam_size=4, ctc_beam=4, sos=1, rnn_lm=RNNLM(pm),
        lm_rate=0.5).decode_problike(lp)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-4)
    assert all(isinstance(s, float) for _, s in got)
    assert torch.is_tensor(RNNLM(pm).predict(np.array([1]), None)[1])
