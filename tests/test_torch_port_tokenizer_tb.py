"""``HuggingTokenizer.train_tokenizer`` and the Trainer's TensorBoard
scalars of lasr_tpu_torch, on the CPU.

  - ``train_tokenizer`` on a seeded text file writes the same
    ``tokenizer.json`` as lasr_tpu's (JSON-equal once the trainer's
    hash-ordered continuation letters are sorted, see ``_canonical``),
    which both packages' ``HuggingTokenizer`` then read alike.
  - A short port ``fit`` writes, from rank 0 under ``exp_dir/tb``, exactly
    the numeric fields of each ``metrics.jsonl`` train line (but ``epoch``
    and ``step``) at the line's step, read back with tensorboard's
    ``EventAccumulator``; another rank, or a missing ``tensorboard``
    package, writes nothing.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lasr_tpu.data.tokenizer import HuggingTokenizer as JaxHuggingTokenizer
from lasr_tpu_torch.data import dataset
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.data.tokenizer import CharTokenizer, HuggingTokenizer
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cli import LETTERS, write_corpus
from tests.torch_port_common import TINY


def _canonical(tokenizer_json):
    """The JSON with the single-character continuation tokens ("##x")
    given their id block in sorted order: the WordPiece trainer adds them
    in hash order, so their ids within the block differ from run to run,
    of one package too.  The rest of the file is deterministic on a
    corpus whose merges have no count ties."""
    vocab = tokenizer_json["model"]["vocab"]
    block = sorted((i, tok) for tok, i in vocab.items()
                   if tok.startswith("##") and len(tok) == 3)
    ids = [i for i, _ in block]
    assert ids == list(range(ids[0], ids[0] + len(ids)))
    vocab.update(zip(sorted(tok for _, tok in block), ids))
    return tokenizer_json


def test_train_tokenizer_writes_lasr_tpu_json(tmp_path):
    pytest.importorskip("tokenizers")
    rng = np.random.default_rng(0)
    # skewed letter and word frequencies: no two merge candidates tie
    letters = list("abcdefghijkl")
    p = 0.7 ** np.arange(len(letters))
    words = ["".join(rng.choice(letters, rng.integers(2, 7), p=p / p.sum()))
             for _ in range(200)]
    wp = 0.97 ** np.arange(len(words))
    text = tmp_path / "train.txt"
    text.write_text("\n".join(" ".join(rng.choice(words, 10, p=wp / wp.sum()))
                              for _ in range(3000)) + "\n")
    paths = {}
    for name, cls in (("port", HuggingTokenizer),
                      ("jax", JaxHuggingTokenizer)):
        paths[name] = str(tmp_path / f"{name}.json")
        cls.train_tokenizer([str(text)], paths[name], vocab_size=120)
    with open(paths["port"]) as a, open(paths["jax"]) as b:
        got, want = json.load(a), json.load(b)
    assert _canonical(got) == _canonical(want)
    vocab = got["model"]["vocab"]
    assert len(vocab) == 120 and list(vocab)[:6] == \
        HuggingTokenizer.SPECIAL_KEY
    line = " ".join(words[:5])
    assert HuggingTokenizer(paths["port"]).encode(line)[0] == \
        JaxHuggingTokenizer(paths["jax"]).encode(line)[0]


ONE_BLOCK = dict(TINY, odim=len(LETTERS) + 6 + 1, encoder_num_blocks=1,
                 decoder_num_block=1)
CHAIN = ["norm", "fbank:20"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("tb")), n16=6, n8=0,
                        seed=7, secs=(0.55, 0.95), n_words=(1, 3),
                        word_len=(1, 4))


def _fit(corpus, exp_dir, rank=0, valid=True):
    scp, txt, dict_path = corpus
    sets = []
    for bs in (3, 6):
        ds = dataset.BatchAudioDataSet(
            wav_list=[scp], text_list=[txt],
            tokenizer=CharTokenizer(dict_path), audio_trans=CHAIN,
            batch_type="size", batch_size=bs, min_duration=0.0,
            text_freq=0.0)
        ds.load_check_data()
        sets.append(ds)
    torch.manual_seed(0)
    trainer = Trainer(
        E2E_Conformer_CTC(**ONE_BLOCK, device="cpu"),
        E2E_Loss(ONE_BLOCK["odim"], smoothing=0.1, rate=0.3),
        Adam(lr=1e-3), DeviceFrontend(CHAIN), exp_dir=str(exp_dir),
        seed=0, log_interval=1, device="cpu")
    trainer.rank = rank
    trainer.fit(trainer.init_state(), sets[0], sets[1] if valid else None,
                num_epochs=2, num_workers=2, save_checkpoints=False)
    return trainer


def test_fit_writes_the_metrics_lines_as_tensorboard_scalars(corpus,
                                                            tmp_path):
    pytest.importorskip("tensorboard")
    trainer = _fit(corpus, tmp_path / "exp")
    trainer._tb.close()
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    events = EventAccumulator(str(tmp_path / "exp" / "tb"))
    events.Reload()
    with open(tmp_path / "exp" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train = [x for x in lines if "loss_main" in x]
    assert len(train) == 4 and len(lines) == 6   # 2 validation lines
    want = {}
    for x in train:
        for k, v in x.items():
            if k not in ("epoch", "step"):
                want.setdefault(k, []).append((x["step"], v))
    assert sorted(events.Tags()["scalars"]) == sorted(want)
    for k, points in want.items():
        got = [(e.step, e.value) for e in events.Scalars(k)]
        assert [s for s, _ in got] == [s for s, _ in points], k
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in points], rtol=1e-6,
                                   err_msg=k)


def test_tensorboard_is_rank_0_only_and_optional(corpus, tmp_path,
                                                  monkeypatch):
    _fit(corpus, tmp_path / "rank1", rank=1, valid=False)
    assert not os.path.exists(tmp_path / "rank1")
    # without the tensorboard package the writer turns itself off
    monkeypatch.setitem(sys.modules,
                        "tensorboard.summary.writer.record_writer", None)
    trainer = _fit(corpus, tmp_path / "no_tb", valid=False)
    assert trainer._tb is False
    assert not os.path.exists(tmp_path / "no_tb" / "tb")
    assert os.path.exists(tmp_path / "no_tb" / "metrics.jsonl")
