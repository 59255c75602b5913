"""What the decoder tests and the card's smoke run build for the
CTC-driven decoders: a CTC head that emits on near-stationary test audio,
and for a character vocabulary a lexicon, a tokens dictionary, an ARPA
bigram LM and a TLG decoding graph with its word table (the port's copy
of the TLG builder; ``lasr_tpu``'s reads the same files).  Imports no
JAX."""

import os

import numpy as np
import torch

from lasr_tpu_torch.decode.ngram_lm import ArpaNgramLM
from lasr_tpu_torch.decode.wfst import write_tlg


def emitting_ctc_head(frames, vocab: int, specials=range(1, 6), seed=0,
                      spread=2.0, blank_share=0.4):
    """(weight (V, D), bias (V,)) of a CTC head that emits on ``frames``
    (N, D), encoder frames of test audio.  Seeded tones and noise give
    frames that differ little over time, and a trained or random head
    puts one token (blank) first on all of them: every CTC-driven decoder
    would return nothing.  This head reads each frame's deviation from
    the frames' mean through seeded weights scaled to spread the logits
    by ~``spread`` nats; ``specials`` get logit -30, and the blank's bias
    is set so that blank wins ``blank_share`` of the frames."""
    frames = frames.float()
    mean = frames.mean(0)
    w = torch.randn(vocab, frames.shape[1],
                    generator=torch.Generator().manual_seed(seed))
    w = w * (spread / float((frames - mean).std() * w.norm(dim=1).mean()))
    w[list(specials)] = 0.0
    b = -w @ mean
    b[list(specials)] = -30.0
    z = frames @ w.T + b
    margin = z[:, 0] - z[:, 1:].max(-1).values
    b[0] -= float(torch.quantile(margin, 1.0 - blank_share))
    return w, b


def write_arpa(path, words, seed=0):
    """A seeded ARPA bigram LM over ``words``: every unigram, and a
    bigram for each word pair drawn with probability 1/2."""
    rng = np.random.default_rng(seed)
    uni = [(f"{-rng.uniform(0.3, 1.2):.4f}", w, f"{-rng.uniform(0.1, 0.5):.4f}")
           for w in words]
    bi = [(f"{-rng.uniform(0.1, 0.6):.4f}", f"{a} {b}")
          for a in ["<s>"] + list(words) for b in list(words) + ["</s>"]
          if rng.uniform() < 0.5]
    lines = ["\\data\\", f"ngram 1={len(words) + 3}", f"ngram 2={len(bi)}",
             "", "\\1-grams:", "-0.5\t<s>\t-0.3", "-0.9\t</s>",
             "-2.0\t<unk>"]
    lines += [f"{p}\t{w}\t{b}" for p, w, b in uni]
    lines += ["", "\\2-grams:"] + [f"{p}\t{ngram}" for p, ngram in bi]
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_word_resources(root, char_ids, words, space_id=None, seed=0,
                         lm_weight=0.5, word_score=-0.5):
    """lexicon.txt, tokens.txt, lm.arpa, tlg.fst.txt and words.txt under
    ``root`` for ``words`` spelled in ``char_ids`` ({char: token id};
    ``space_id`` adds a ``<space>`` token).  Returns the decode-config
    keys of ``ctc_kenlm`` and of ``wfst`` (two dicts)."""
    os.makedirs(root, exist_ok=True)
    path = {k: os.path.join(root, n) for k, n in (
        ("lexicon", "lexicon.txt"), ("tokens", "tokens.txt"),
        ("arpa", "lm.arpa"), ("fst", "tlg.fst.txt"), ("word", "words.txt"))}
    with open(path["lexicon"], "w") as f:
        f.write("".join(f"{w} {' '.join(w)}\n" for w in words))
    with open(path["tokens"], "w") as f:
        f.write("".join(f"{c} {i}\n" for c, i in sorted(char_ids.items())))
        if space_id is not None:
            f.write(f"<space> {space_id}\n")
    write_arpa(path["arpa"], words, seed)
    n_tokens = max(char_ids.values()) + 1
    write_tlg(path["fst"], path["word"],
              {w: [char_ids[c] for c in w] for w in words},
              ArpaNgramLM(path["arpa"]), lm_weight=lm_weight,
              word_score=word_score, n_tokens=n_tokens)
    kenlm = {"lexicon": path["lexicon"], "tokens_dict": path["tokens"],
             "kenlm_model": path["arpa"], "beam_threshold": 50.0,
             "lm_weight": lm_weight, "word_score": word_score}
    if space_id is not None:
        kenlm.update(sil="<space>", sil_score=0.0)
    wfst = {"fst": path["fst"], "word": path["word"], "wfst_beam": 50.0,
            "max_active": 200, "acoustic_scale": 1.0}
    return kenlm, wfst
