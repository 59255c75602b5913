"""Lexicon-constrained CTC beam search with an n-gram word LM.

The port's copy of ``lasr_tpu/decode/ctc_w2l.py`` (numpy and Python on the
host; the port imports nothing of ``lasr_tpu``).

First-party equivalent of the reference's ``CTC_KenLM_Decoder``
(ctc_w2l_decoder.py:30-93), which wires flashlight's ``LexiconDecoder``
+ ``KenLM`` + ``Trie``: same constructor surface and
``decode_problike(probs)`` API, with the native deps replaced by
``ngram_lm.ArpaNgramLM`` (``kenlm_model`` takes the ARPA text the KenLM
binary would be compiled from) and a python token-trie beam search that
follows flashlight's ``LexiconDecoderOptions`` semantics:

  - hypotheses advance through a trie of token spellings; entering a
    child accrues the MAX-smeared LM lookahead (``Trie.smear(MAX)``,
    ctc_w2l_decoder.py:63), replaced by the true ``lm.score`` when a
    complete word is emitted (+ ``word_score``; ``unk_score`` for words
    outside the LM),
  - CTC criterion: blank and repeated-token transitions keep the trie
    position; a repeated label needs an intervening blank to re-enter,
  - hypotheses merge by (trie node, LM state, last token) with log-add
    or max combination (``log_add`` option),
  - pruning by ``beam_size`` and ``beam_threshold`` per frame,
  - ``sil`` (when given) is a re-enterable silence token scored with
    ``sil_score``; otherwise silence is the blank, as in the reference
    (ctc_w2l_decoder.py:45-49).

Like the reference's flashlight call (and ``ctc_bs.py``), this DP is
host-side by design: the GPU does one encoder+CTC pass; the search runs
on the (T, V) posterior matrix.  LM scores are log10 (KenLM domain), so
``lm_weight`` values from KenLM recipes transfer unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lasr_tpu_torch.decode.ngram_lm import ArpaNgramLM, read_dict

NEG_INF = -float("inf")


def load_words(path: str) -> "Dict[str, List[List[str]]]":
    """flashlight ``load_words``: ``word tok1 tok2 ...`` per line; a word
    may repeat with alternative spellings."""
    out: Dict[str, List[List[str]]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split()
            if not parts:
                continue
            out.setdefault(parts[0], []).append(parts[1:])
    return out


class TrieNode:
    __slots__ = ("children", "labels", "max_score")

    def __init__(self):
        self.children: Dict[int, TrieNode] = {}
        # (word_id or None for unk, true LM start score or unk marker)
        self.labels: List[Tuple[Optional[int], float]] = []
        self.max_score = NEG_INF


class Trie:
    """Token-spelling trie with MAX smearing (flashlight Trie parity)."""

    def __init__(self):
        self.root = TrieNode()

    def insert(self, spelling: Sequence[int], word_id: Optional[int],
               score: float) -> None:
        node = self.root
        for tok in spelling:
            node = node.children.setdefault(tok, TrieNode())
        node.labels.append((word_id, score))

    def smear_max(self) -> None:
        def rec(node: TrieNode) -> float:
            best = max((s for _, s in node.labels), default=NEG_INF)
            for ch in node.children.values():
                best = max(best, rec(ch))
            node.max_score = best
            return best
        rec(self.root)
        if self.root.max_score == NEG_INF:
            self.root.max_score = 0.0


class _Hyp:
    __slots__ = ("score", "node", "lm_state", "prev", "words", "toks",
                 "lm_acc")

    def __init__(self, score, node, lm_state, prev, words, toks, lm_acc):
        self.score = score          # am + lm_weight*(true+smeared) + bonuses
        self.node = node
        self.lm_state = lm_state
        self.prev = prev            # last emitted token (-1 after blank)
        self.words = words          # tuple of word ids (None = unk)
        self.toks = toks            # tuple of emitted token ids (collapsed)
        self.lm_acc = lm_acc        # smeared lookahead currently applied


class CTC_KenLM_Decoder:
    """Constructor surface == reference ctc_w2l_decoder.py:31-37."""

    def __init__(self, beam_size: int, beam_threshold: float,
                 lexicon: str = None, tokens_dict: str = None,
                 kenlm_model: str = None,
                 sos: str = "<eos>", blk: str = "<blank>",
                 unk: str = "<unk>", sil: Optional[str] = None,
                 lm_weight: float = 2.0, word_score: float = -1.0,
                 unk_score: float = -math.inf, sil_score: float = 0.0,
                 log_add: bool = False,
                 beam_size_token: Optional[int] = None):
        self.beam_size = beam_size
        self.beam_threshold = beam_threshold
        # flashlight LexiconDecoderOptions arg 2: only the top-K tokens
        # by AM score expand at each frame (None/0 = all; the reference
        # passes len(tokens_dict), i.e. unrestricted)
        self.beam_size_token = beam_size_token
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.unk_score = unk_score
        self.sil_score = sil_score
        self.log_add = log_add

        words = load_words(lexicon)
        self.word_list = list(words.keys())
        word_ids = {w: i for i, w in enumerate(self.word_list)}

        toks = read_dict(tokens_dict, eos=sos)
        if blk not in toks:
            toks[blk] = 0
        self.blank = toks[blk]
        self.silence = toks[sil] if sil else toks[blk]
        self._sil_is_blank = not sil or toks[sil] == toks[blk]
        unk_tok = toks.get(unk)

        self.lm = ArpaNgramLM(kenlm_model, vocab=None)

        self.trie = Trie()
        start = self.lm.start()
        for word, spellings in words.items():
            wid = word_ids[word]
            in_lm = word in self.lm.vocab
            if in_lm:
                _, s = self.lm.score_word(start, word)
            else:
                s = unk_score if unk_score != -math.inf else -1e30
            for sp in spellings:
                ids = [toks[t] if t in toks else unk_tok for t in sp]
                if any(i is None for i in ids):
                    continue
                self.trie.insert(ids, wid if in_lm else None, s)
        self.trie.smear_max()

    # ---- search ----

    def _merge(self, table: dict, hyp: _Hyp) -> None:
        """Recombine hypotheses sharing (trie node, LM state, last token):
        max (Viterbi) or log-add per the ``log_add`` option, keeping the
        better branch's history (flashlight LexiconDecoder merge)."""
        key = (id(hyp.node), hyp.lm_state, hyp.prev)
        old = table.get(key)
        if old is None:
            table[key] = hyp
            return
        hi, lo = (hyp, old) if hyp.score > old.score else (old, hyp)
        if self.log_add:
            hi.score = hi.score + math.log1p(math.exp(lo.score - hi.score))
        table[key] = hi

    def decode_problike(self, probs: np.ndarray, do_log: bool = False
                        ) -> List[Tuple[List[int], float]]:
        """probs: (T, V) posteriors (or log-domain scores with
        do_log=False semantics matching the reference: pass posteriors
        and set do_log=True to take the log here).  Returns the N-best
        [(collapsed token ids, total score)] like the reference's
        ``decode_problike`` + ``get_tokens``."""
        # h.toks is already the collapsed emission sequence (one entry per
        # emitted label — a legitimate cross-word repeat stays doubled);
        # only blanks/silences need stripping, matching what the
        # reference's frame-level get_tokens produces net.
        return [([t for t in h.toks if t != self.blank], s)
                for h, s in self._search(probs, do_log)]

    def _search(self, probs: np.ndarray, do_log: bool
                ) -> List[Tuple[_Hyp, float]]:
        lp = np.log(np.maximum(probs, 1e-300)) if do_log else probs
        T, V = lp.shape
        root = self.trie.root
        hyps = [_Hyp(0.0, root, self.lm.start(), -1, (), (), 0.0)]

        topk = self.beam_size_token
        for t in range(T):
            allowed = None
            if topk and topk < V:
                allowed = set(np.argpartition(lp[t], -topk)[-topk:].tolist())
            table: dict = {}
            for h in hyps:
                # flashlight applies the top-K to EVERY token proposal —
                # blank/repeat/silence included, not just trie descends
                # (LexiconDecoder::decode iterates only the top
                # beamSizeToken indices per frame)
                # 1) blank: trie position and lm state survive
                if allowed is None or self.blank in allowed:
                    b = lp[t, self.blank]
                    self._merge(table, _Hyp(h.score + b, h.node, h.lm_state,
                                            -1, h.words, h.toks, h.lm_acc))
                # 2) repeat the previous token (CTC collapse)
                if h.prev >= 0 and (allowed is None or h.prev in allowed):
                    self._merge(table, _Hyp(h.score + lp[t, h.prev], h.node,
                                            h.lm_state, h.prev, h.words,
                                            h.toks, h.lm_acc))
                # 3) silence as a re-enterable token (only when distinct)
                if not self._sil_is_blank and h.node is root \
                        and (allowed is None or self.silence in allowed):
                    s = h.score + lp[t, self.silence] + self.sil_score
                    self._merge(table, _Hyp(s, root, h.lm_state,
                                            self.silence, h.words,
                                            h.toks + (self.silence,),
                                            h.lm_acc))
                # 4) descend into trie children
                for tok, child in h.node.children.items():
                    if tok == h.prev:   # repeated label needs a blank gap
                        continue
                    if allowed is not None and tok not in allowed:
                        continue
                    base = h.score + lp[t, tok] + self.lm_weight * (
                        child.max_score - h.node.max_score)
                    acc = h.lm_acc + (child.max_score - h.node.max_score)
                    self._merge(table, _Hyp(base, child, h.lm_state, tok,
                                            h.words,
                                            h.toks + (tok,), acc))
                    # word completions at this child
                    for wid, true_s in child.labels:
                        if wid is None:
                            if self.unk_score == -math.inf:
                                continue
                            st2, lm_s = h.lm_state, self.unk_score
                        else:
                            st2, lm_s = self.lm.score(
                                h.lm_state, self.lm.vocab[
                                    self.word_list[wid]])
                        s = (h.score + lp[t, tok]
                             + self.lm_weight * (lm_s - h.lm_acc)
                             + self.word_score)
                        self._merge(table, _Hyp(s, root, st2, tok,
                                                h.words + (wid,),
                                                h.toks + (tok,), 0.0))
            hyps = sorted(table.values(), key=lambda x: -x.score)
            if hyps:
                cut = hyps[0].score - self.beam_threshold
                hyps = [h for h in hyps[: self.beam_size] if h.score >= cut]

        # finalize: only complete-word hypotheses (trie root) are
        # eligible, with the sentence-end LM prob added — flashlight's
        # decodeEnd drops mid-word hypotheses the same way.  If the beam
        # holds no complete hypothesis (e.g. audio truncated mid-word),
        # fall back to the smeared estimates so the decoder still answers.
        out = [(h, h.score + self.lm_weight * self.lm.finish(h.lm_state))
               for h in hyps if h.node is root]
        if not out:
            out = [(h, h.score) for h in hyps]
        out.sort(key=lambda p: -p[1])
        return out

    def get_tokens(self, idxs: Sequence[int]) -> List[int]:
        """Collapse repeats and strip blanks (reference
        ctc_w2l_decoder.py:88-93). Our ``toks`` are already collapsed;
        kept for API parity and for callers passing raw frames."""
        import itertools as it
        idxs = (g[0] for g in it.groupby(idxs))
        return [i for i in idxs if i != self.blank]

    def decode_words(self, probs: np.ndarray, do_log: bool = False
                     ) -> List[Tuple[List[str], float]]:
        """Convenience: N-best word strings (the lexicon makes the word
        sequence exact, unlike token-level decoders)."""
        out = []
        for h, s in self._search(probs, do_log):
            out.append(([self.word_list[w] if w is not None else "<unk>"
                         for w in h.words], s))
        return out
