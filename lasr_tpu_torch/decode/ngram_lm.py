"""First-party word n-gram language model over ARPA text files.

The port's copy of ``lasr_tpu/decode/ngram_lm.py`` (numpy and Python on the
host; the port imports nothing of ``lasr_tpu``).

The reference's ``CTC_KenLM_Decoder`` (ctc_w2l_decoder.py:30-93) scores
words with a KenLM binary through flashlight's ``KenLM`` wrapper; KenLM
binaries are *compiled from* ARPA text, which is the interchange format
every n-gram toolkit (SRILM/KenLM/pocolm) emits.  This module loads the
ARPA directly and reproduces the standard Katz-backoff scoring
semantics, so the lexicon decoder (ctc_w2l.py) needs no native KenLM:

    p(w | c) = prob(c, w)                       if (c, w) listed
             = backoff(c) + p(w | c[1:])        otherwise

Scores are log10 (the ARPA/KenLM convention — ``lm_weight`` values tuned
for KenLM-based recipes transfer unchanged).  States are tuples of word
ids (the context), canonicalised to the longest suffix that exists as a
context in the table, exactly like KenLM's state recombination.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

LOG10_ZERO = -99.0  # ARPA convention for "no probability"


def read_dict(path: str, sc: str = " ", append: bool = True,
              eos: str = "<eos>") -> Dict[str, int]:
    """``token id`` per line → dict (reference reader.py:83-94 parity,
    including the appended eos entry)."""
    out: Dict[str, int] = {}
    last = 0
    with open(path, encoding="utf-8") as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            key, value = line.split(sc)[0], int(line.split(sc)[1])
            out[key] = value
            last = value + 1
    if append:
        out[eos] = last
    return out


class ArpaNgramLM:
    """Katz-backoff n-gram LM from an ARPA file.

    ``vocab`` maps word string → id; by default it is built from the
    ARPA's own unigram list.  The flashlight-style API used by the
    lexicon decoder:

        state = lm.start()
        state, s = lm.score(state, word_id)   # log10
        s_end = lm.finish(state)              # log10 p(</s> | state)
    """

    UNK = "<unk>"

    def __init__(self, path: str,
                 vocab: Optional[Dict[str, int]] = None) -> None:
        # (context words tuple, word) -> (log10 prob, log10 backoff of the
        # *full* gram when it is itself a context)
        probs: Dict[Tuple[Tuple[int, ...], int], float] = {}
        backoffs: Dict[Tuple[int, ...], float] = {}
        order = 0

        # two passes so grams can be interned against a stable vocab
        sections: List[Tuple[int, List[str]]] = []
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines) and lines[i].strip() != "\\data\\":
            i += 1
        i += 1
        counts = {}
        while i < len(lines) and lines[i].strip().startswith("ngram"):
            head, n = lines[i].strip().split("=")
            counts[int(head.split()[1])] = int(n)
            i += 1
        while i < len(lines):
            s = lines[i].strip()
            if s.endswith("-grams:") and s.startswith("\\"):
                n = int(s[1:].split("-")[0])
                order = max(order, n)
                i += 1
                block: List[str] = []
                while i < len(lines) and not lines[i].strip().startswith("\\"):
                    if lines[i].strip():
                        block.append(lines[i])
                    i += 1
                sections.append((n, block))
            else:
                i += 1
        if not sections:
            raise ValueError(f"{path}: no \\N-grams: sections found")

        if vocab is None:
            vocab = {}
            for n, block in sections:
                if n != 1:
                    continue
                for line in block:
                    word = line.split()[1]
                    if word not in vocab:
                        vocab[word] = len(vocab)
        self.vocab = vocab
        self.unk_id = vocab.get(self.UNK)

        for n, block in sections:
            for line in block:
                parts = line.split()
                logp = float(parts[0])
                words = parts[1:1 + n]
                bo = float(parts[1 + n]) if len(parts) > 1 + n else 0.0
                try:
                    ids = tuple(vocab[w] for w in words)
                except KeyError:
                    continue  # gram over words outside the given vocab
                probs[(ids[:-1], ids[-1])] = logp
                if len(parts) > 1 + n:   # explicit backoff field
                    backoffs[ids] = bo

        self.order = order
        self._probs = probs
        self._backoffs = backoffs
        self._bos = vocab.get("<s>")
        self._eos = vocab.get("</s>")

    # ---- flashlight-style API ----

    def start(self, include_bos: bool = True) -> Tuple[int, ...]:
        if include_bos and self._bos is not None:
            return (self._bos,)
        return ()

    def _canon(self, ctx: Tuple[int, ...]) -> Tuple[int, ...]:
        """Longest suffix of ctx that exists as a context (KenLM state
        recombination: context words that no listed gram extends can
        never influence a future score)."""
        while ctx and ctx not in self._backoffs \
                and ctx not in self._ctx_cache():
            ctx = ctx[1:]
        return ctx

    def _ctx_cache(self):
        c = getattr(self, "_ctx_set", None)
        if c is None:
            c = {k[0] for k in self._probs}
            self._ctx_set = c
        return c

    def _raw_score(self, ctx: Tuple[int, ...], word: int) -> float:
        key = (ctx, word)
        if key in self._probs:
            return self._probs[key]
        if not ctx:
            # OOV at the unigram level
            if self.unk_id is not None and ((), self.unk_id) in self._probs:
                return self._probs[((), self.unk_id)]
            return LOG10_ZERO
        bo = self._backoffs.get(ctx, 0.0)
        return bo + self._raw_score(ctx[1:], word)

    def score(self, state: Sequence[int], word: int
              ) -> Tuple[Tuple[int, ...], float]:
        ctx = tuple(state)[-(self.order - 1):] if self.order > 1 else ()
        ctx = self._canon(ctx)
        s = self._raw_score(ctx, word)
        new = (ctx + (word,))[-(self.order - 1):] if self.order > 1 else ()
        return self._canon(new), s

    def finish(self, state: Sequence[int]) -> float:
        if self._eos is None:
            return 0.0
        _, s = self.score(state, self._eos)
        return s

    def score_word(self, state: Sequence[int], word: str
                   ) -> Tuple[Tuple[int, ...], float]:
        wid = self.vocab.get(word, self.unk_id)
        if wid is None:
            return tuple(state), LOG10_ZERO
        return self.score(state, wid)

    def sentence_logprob(self, words: Sequence[str],
                         include_eos: bool = True) -> float:
        st = self.start()
        total = 0.0
        for w in words:
            st, s = self.score_word(st, w)
            total += s
        if include_eos:
            total += self.finish(st)
        return total
