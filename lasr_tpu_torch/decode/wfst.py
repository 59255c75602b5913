"""First-party WFST Viterbi decoding (tropical semiring).

The port's copy of ``lasr_tpu/decode/wfst.py`` (numpy and Python on the
host; the port imports nothing of ``lasr_tpu``).  It also holds
``tools/build_tlg.py``'s TLG builder (``build_lg``, ``compose_ctc``,
``write_tlg``), which ``lasr_tpu``'s tests build their graphs with.

The reference's ``Kaldi_Decoder`` (kaldi_decoder.py:15-33) wraps
pykaldi's ``MappedLatticeFasterRecognizer`` over a compiled decoding
graph.  This module keeps the same constructor/`decode_loglike` surface
with the native deps replaced by a text-format FST loader and a
frame-synchronous Viterbi beam search:

  - ``fst``: the decoding graph, either OpenFst BINARY (the ``HCLG.fst``
    / ``TLG.fst`` artifact Kaldi's ``mkgraph.sh`` ships — ``vector`` and
    ``const`` fst types, ``standard`` (tropical) arcs, attached symbol
    tables skipped; auto-detected by the 0x7EB2FDD6 magic) or OpenFst
    TEXT format (``fstprint`` output: ``src dst ilabel olabel [weight]``
    arc lines and ``state [weight]`` final lines; ilabel 0 = epsilon).
  - ``word``: the output symbol table (``word id`` per line).
  - ``mdl``: ilabel → posterior-column map.  Kaldi uses a transition
    model (transition-id → pdf); pass a text file of ``ilabel pdf``
    lines for that case, or ``None`` for the CTC TLG convention
    (column = ilabel - 1; documented deviation — this image has no
    Kaldi transition models to read).

Costs follow Kaldi: path cost = graph weight + ``acoustic_scale`` x
(-loglike); pruning by ``beam`` (cost width) and ``max_active``
(histogram cap), epsilon arcs closed each frame.  Host-side DP like the
reference (pykaldi decodes on CPU); the GPU produces the loglikes.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from lasr_tpu_torch.decode.ngram_lm import ArpaNgramLM


#: OpenFst binary framing constants (public format, fst/fst.h /
#: fst/symbol-table.h: kFstMagicNumber / kSymbolTableMagicNumber; the
#: vector/const state+arc layouts follow fst/vector-fst.h
#: VectorFst::WriteFst and fst/const-fst.h ConstFst::WriteFst).
FST_MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996
_FLAG_ISYMBOLS = 0x1
_FLAG_OSYMBOLS = 0x2
_CONST_ALIGNED_VERSION = 1    # const-fst kAlignedFileVersion
_CONST_FILE_ALIGN = 16        # const-fst kFileAlign / MappedFile alignment


class _BinCursor:
    """Little-endian cursor over OpenFst's WriteType framing."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def _take(self, n: int) -> bytes:
        b = self.d[self.o:self.o + n]
        if len(b) != n:
            raise ValueError("truncated OpenFst binary")
        self.o += n
        return b

    def i32(self) -> int:
        return int.from_bytes(self._take(4), "little", signed=True)

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "little", signed=False)

    def i64(self) -> int:
        return int.from_bytes(self._take(8), "little", signed=True)

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little", signed=False)

    def f32(self) -> float:
        import struct
        return struct.unpack("<f", self._take(4))[0]

    def string(self) -> str:
        return self._take(self.i32()).decode("utf-8", errors="replace")

    def align(self, k: int) -> None:
        self.o = (self.o + k - 1) // k * k


class StdFst:
    """Tropical-semiring WFST from OpenFst binary OR text format."""

    def __init__(self, path: str):
        # arcs[state] = list of (ilabel, olabel, weight, nextstate)
        self.arcs: Dict[int, List[Tuple[int, int, float, int]]] = {}
        self.finals: Dict[int, float] = {}
        self.start = 0
        self.isymbols: Optional[Dict[int, str]] = None
        self.osymbols: Optional[Dict[int, str]] = None
        with open(path, "rb") as f:
            raw = f.read()
        if (len(raw) >= 4
                and int.from_bytes(raw[:4], "little", signed=True)
                == FST_MAGIC):
            self._parse_binary(raw)
            return
        self._parse_text(raw.decode("utf-8"))

    @classmethod
    def from_parts(cls, start: int,
                   arcs: Dict[int, List[Tuple[int, int, float, int]]],
                   finals: Dict[int, float]) -> "StdFst":
        """Build in memory (graph builders, e.g. tools/build_tlg.py)."""
        fst = cls.__new__(cls)
        fst.start = start
        fst.arcs = {s: list(a) for s, a in arcs.items()}
        fst.finals = dict(finals)
        fst.isymbols = fst.osymbols = None
        return fst

    def _parse_text(self, text: str) -> None:
        first = True
        for line in text.splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                src, dst, il, ol = (int(parts[0]), int(parts[1]),
                                    int(parts[2]), int(parts[3]))
                w = float(parts[4]) if len(parts) > 4 else 0.0
                self.arcs.setdefault(src, []).append((il, ol, w, dst))
                if first:
                    self.start = src
                    first = False
            elif len(parts) <= 2:
                st = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                self.finals[st] = w
                if first:
                    self.start = st
                    first = False

    def _parse_binary(self, raw: bytes) -> None:
        """Parse OpenFst binary (the compiled ``HCLG.fst`` Kaldi ships).

        Header framing per fst/fst.h FstHeader::Read; ``vector`` body per
        fst/vector-fst.h (per state: final f32, narcs i64, arcs as
        (ilabel i32, olabel i32, weight f32, nextstate i32)); ``const``
        body per fst/const-fst.h (ConstState array {final f32, pos u32,
        narcs u32, niepsilons u32, noepsilons u32} then one flat arc
        array, 16-byte aligned when header version == 1).  Attached
        symbol tables (header flags 0x1/0x2) are read and kept on
        ``self.isymbols``/``self.osymbols``.
        """
        c = _BinCursor(raw)
        magic = c.i32()
        assert magic == FST_MAGIC
        fsttype = c.string()
        arctype = c.string()
        if arctype != "standard":
            raise ValueError(
                f"unsupported OpenFst arc type {arctype!r} "
                "(tropical 'standard' arcs only)")
        version = c.i32()
        flags = c.i32()
        c.u64()                       # properties
        self.start = c.i64()
        numstates = c.i64()
        numarcs = c.i64()
        self.isymbols = (self._read_symbol_table(c)
                         if flags & _FLAG_ISYMBOLS else None)
        self.osymbols = (self._read_symbol_table(c)
                         if flags & _FLAG_OSYMBOLS else None)
        if fsttype == "vector":
            for s in range(numstates):
                final = c.f32()
                if final != math.inf:
                    self.finals[s] = final
                narcs = c.i64()
                if narcs:
                    self.arcs[s] = [(c.i32(), c.i32(), c.f32(), c.i32())
                                    for _ in range(narcs)]
        elif fsttype == "const":
            aligned = version == _CONST_ALIGNED_VERSION
            if aligned:
                c.align(_CONST_FILE_ALIGN)
            states = []
            for s in range(numstates):
                final, pos, narcs = c.f32(), c.u32(), c.u32()
                c.u32(), c.u32()      # niepsilons / noepsilons
                states.append((final, pos, narcs))
            if aligned:
                c.align(_CONST_FILE_ALIGN)
            arcs = [(c.i32(), c.i32(), c.f32(), c.i32())
                    for _ in range(numarcs)]
            for s, (final, pos, narcs) in enumerate(states):
                if final != math.inf:
                    self.finals[s] = final
                if narcs:
                    self.arcs[s] = arcs[pos:pos + narcs]
        else:
            raise ValueError(
                f"unsupported OpenFst fst type {fsttype!r} "
                "('vector'/'const' only — run fstconvert or fstprint)")

    def write_binary(self, path: str) -> None:
        """Serialize as an OpenFst ``vector``/``standard`` binary readable
        by OpenFst/Kaldi tools AND by this loader (round-trip pinned in
        tests/test_wfst_binary.py)."""
        import struct

        def ws(out: bytearray, s: str) -> None:
            b = s.encode()
            out += struct.pack("<i", len(b)) + b

        def symtab(out: bytearray, syms: Dict[int, str]) -> None:
            out += struct.pack("<i", SYMBOL_TABLE_MAGIC)
            ws(out, "lasr")
            out += struct.pack("<qq", max(syms, default=-1) + 1, len(syms))
            for key in sorted(syms):
                ws(out, syms[key])
                out += struct.pack("<q", key)

        n_states = max([self.start]
                       + [s for s in self.arcs]
                       + [a[3] for arcs in self.arcs.values() for a in arcs]
                       + list(self.finals)) + 1
        n_arcs = sum(len(a) for a in self.arcs.values())
        flags = ((self.isymbols is not None and _FLAG_ISYMBOLS or 0)
                 | (self.osymbols is not None and _FLAG_OSYMBOLS or 0))
        out = bytearray(struct.pack("<i", FST_MAGIC))
        ws(out, "vector")
        ws(out, "standard")
        out += struct.pack("<iiQqqq", 2, flags, 0, self.start, n_states,
                           n_arcs)
        if self.isymbols is not None:
            symtab(out, self.isymbols)
        if self.osymbols is not None:
            symtab(out, self.osymbols)
        for s in range(n_states):
            out += struct.pack("<f", self.finals.get(s, math.inf))
            arcs = self.arcs.get(s, [])
            out += struct.pack("<q", len(arcs))
            for il, ol, w, dst in arcs:
                out += struct.pack("<iifi", il, ol, w, dst)
        with open(path, "wb") as f:
            f.write(bytes(out))

    @staticmethod
    def _read_symbol_table(c: "_BinCursor") -> Dict[int, str]:
        """fst/symbol-table.h SymbolTableImpl::Write framing."""
        magic = c.i32()
        if magic != SYMBOL_TABLE_MAGIC:
            raise ValueError("bad attached symbol-table magic")
        c.string()                    # table name
        c.i64()                       # available_key
        size = c.i64()
        out: Dict[int, str] = {}
        for _ in range(size):
            sym = c.string()
            out[c.i64()] = sym
        return out


def read_symbols(path: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().splitlines():
            parts = line.split()
            if len(parts) >= 2:
                out[int(parts[1])] = parts[0]
    return out


class _Tok:
    __slots__ = ("cost", "olabels", "ilabels")

    def __init__(self, cost, olabels, ilabels):
        self.cost = cost
        self.olabels = olabels      # tuple of emitted output labels
        self.ilabels = ilabels      # tuple of consumed input labels


class Kaldi_Decoder:
    """Constructor surface == reference kaldi_decoder.py:16-28."""

    def __init__(self, beam: float, max_active: int, mdl: Optional[str],
                 fst: str, word: str, acoustic_scale: float = 0.1):
        self.beam = float(beam)
        self.max_active = int(max_active)
        self.acoustic_scale = float(acoustic_scale)
        self.fst = StdFst(fst)
        self.words = read_symbols(word)
        self.ilabel_map: Optional[Dict[int, int]] = None
        if mdl:
            self.ilabel_map = {}
            with open(mdl, encoding="utf-8") as f:
                for line in f.read().splitlines():
                    parts = line.split()
                    if len(parts) >= 2:
                        self.ilabel_map[int(parts[0])] = int(parts[1])

    def _col(self, ilabel: int) -> int:
        if self.ilabel_map is not None:
            return self.ilabel_map[ilabel]
        return ilabel - 1   # CTC TLG convention

    def _eps_close(self, toks: Dict[int, _Tok]) -> Dict[int, _Tok]:
        """Relax epsilon (ilabel 0) arcs to fixpoint (tropical)."""
        heap = [(t.cost, s) for s, t in toks.items()]
        heapq.heapify(heap)
        while heap:
            cost, s = heapq.heappop(heap)
            tok = toks.get(s)
            if tok is None or cost > tok.cost:
                continue
            for il, ol, w, dst in self.fst.arcs.get(s, ()):
                if il != 0:
                    continue
                nc = cost + w
                old = toks.get(dst)
                if old is None or nc < old.cost:
                    toks[dst] = _Tok(
                        nc,
                        tok.olabels + ((ol,) if ol != 0 else ()),
                        tok.ilabels)
                    heapq.heappush(heap, (nc, dst))
        return toks

    def _prune(self, toks: Dict[int, _Tok]) -> Dict[int, _Tok]:
        if not toks:
            return toks
        best = min(t.cost for t in toks.values())
        kept = {s: t for s, t in toks.items() if t.cost <= best + self.beam}
        if len(kept) > self.max_active:
            order = sorted(kept.items(), key=lambda kv: kv[1].cost)
            kept = dict(order[: self.max_active])
        return kept

    def decode_loglike(self, loglikes: np.ndarray) -> Dict:
        """loglikes: (T, N) log-likelihoods (or log-posteriors for CTC
        graphs).  Returns {"text", "words", "alignment", "likelihood"}
        — the fields pykaldi's recognizer output carries
        (kaldi_decoder.py:30-33 returns that object directly)."""
        loglikes = np.asarray(loglikes, np.float64)
        T = loglikes.shape[0]
        toks: Dict[int, _Tok] = {self.fst.start: _Tok(0.0, (), ())}
        toks = self._eps_close(toks)
        for t in range(T):
            toks = self._prune(toks)
            new: Dict[int, _Tok] = {}
            for s, tok in toks.items():
                for il, ol, w, dst in self.fst.arcs.get(s, ()):
                    if il == 0:
                        continue
                    col = self._col(il)
                    nc = (tok.cost + w
                          - self.acoustic_scale * loglikes[t, col])
                    old = new.get(dst)
                    if old is None or nc < old.cost:
                        new[dst] = _Tok(
                            nc,
                            tok.olabels + ((ol,) if ol != 0 else ()),
                            tok.ilabels + (il,))
            toks = self._eps_close(new)
            if not toks:
                break
        # final weights
        best: Optional[Tuple[float, _Tok]] = None
        for s, tok in toks.items():
            if s in self.fst.finals:
                c = tok.cost + self.fst.finals[s]
                if best is None or c < best[0]:
                    best = (c, tok)
        if best is None and toks:   # no reachable final: best partial
            s, tok = min(toks.items(), key=lambda kv: kv[1].cost)
            best = (tok.cost, tok)
        if best is None:
            return {"text": "", "words": [], "alignment": [],
                    "likelihood": -math.inf}
        cost, tok = best
        words = [self.words.get(o, str(o)) for o in tok.olabels]
        return {"text": " ".join(words), "words": list(tok.olabels),
                "alignment": list(tok.ilabels), "likelihood": -cost}


# ---- the TLG builder (tools/build_tlg.py): T (the CTC topology: blank
# self-loops, repeat collapse, a blank gap before a repeated label) o L
# (word spellings) o G (the n-gram LM expanded exactly: one arc per
# (context, word) carrying ``lm.score``'s value, backoff folded in).
# Word-final arcs cost -(lm_weight*lm + word_score), final states
# -lm_weight*finish; ilabel = token + 1 (blank = 1).


def build_lg(lexicon: Dict[str, List[int]], lm: ArpaNgramLM,
             lm_weight: float, word_score: float):
    """Letter-level LG: states = LM contexts + in-word positions.

    The full LM weight sits on the word-FINAL letter arc (tropical total
    is placement-invariant; the pinned equality is on unpruned search).
    Returns (arcs [(src, dst, tok, word_id, cost)], finals {state: cost},
    start, word list)."""
    words = sorted(lexicon)
    ctx_key: Dict[tuple, int] = {}
    states = 0

    def ctx_state(key):
        nonlocal states
        if key not in ctx_key:
            ctx_key[key] = states
            states += 1
        return ctx_key[key]

    start_state = lm.start()
    todo = [start_state]
    start = ctx_state(start_state)
    arcs: List[Tuple[int, int, int, int, float]] = []
    seen = {start_state}
    while todo:
        st = todo.pop()
        src = ctx_state(st)
        for wid, w in enumerate(words):
            st2, s = lm.score_word(st, w)
            if st2 not in seen:
                seen.add(st2)
                todo.append(st2)
            dst = ctx_state(st2)
            sp = lexicon[w]
            cost = -(lm_weight * s + word_score)
            cur = src
            for j, tok in enumerate(sp):
                if j == len(sp) - 1:
                    arcs.append((cur, dst, tok, wid + 1, cost))
                else:
                    mid = states
                    states += 1
                    arcs.append((cur, mid, tok, 0, 0.0))
                    cur = mid
    finals = {}
    for key, sid_ in ctx_key.items():
        finals[sid_] = -lm_weight * lm.finish(key)
    return arcs, finals, start, words


def compose_ctc(arcs, finals, start, n_tokens: int):
    """Apply the CTC topology over a letter-arc graph.

    States are (lg_state, last_label): blank self-loops everywhere, a
    taken letter arc lands in a repeat-collapse self-loop, and an arc
    with the SAME label as the last emission is only reachable after a
    blank (Eesen T semantics — what CTC_KenLM_Decoder's ``tok == h.prev``
    gap rule enforces, ctc_w2l.py).  ilabel = letter + 1 (blank = 1)."""
    out_arcs: List[Tuple[int, int, int, int, float]] = []
    out_finals: Dict[int, float] = {}
    by_src: Dict[int, List[Tuple[int, int, int, int, float]]] = {}
    for a in arcs:
        by_src.setdefault(a[0], []).append(a)

    state_id: Dict[Tuple[int, int], int] = {}

    def sid(q, label):
        if (q, label) not in state_id:
            state_id[(q, label)] = len(state_id)
        return state_id[(q, label)]

    BLANK = 0
    todo = [(start, BLANK)]
    seen = {(start, BLANK)}
    while todo:
        q, lab = todo.pop()
        s = sid((q), lab)
        # blank self-transition (resets the repeat context)
        tgt = (q, BLANK)
        out_arcs.append((s, sid(*tgt), 1, 0, 0.0))
        if tgt not in seen:
            seen.add(tgt)
            todo.append(tgt)
        if lab != BLANK:
            # repeat-collapse self-loop
            out_arcs.append((s, s, lab + 1, 0, 0.0))
        for (_src, dst, tok, ol, w) in by_src.get(q, ()):
            if tok == lab:      # repeated label needs a blank gap
                continue
            tgt = (dst, tok)
            out_arcs.append((s, sid(*tgt), tok + 1, ol, w))
            if tgt not in seen:
                seen.add(tgt)
                todo.append(tgt)
        if q in finals:
            out_finals[s] = finals[q]
    return out_arcs, out_finals, sid(start, BLANK), len(state_id)


def write_tlg(path_fst: str, path_words: str, lexicon, lm: ArpaNgramLM,
              lm_weight: float = 2.0, word_score: float = -1.0,
              n_tokens: int = 26, binary: bool = False):
    """Build + write the TLG (OpenFst text, or binary vector-fst with
    ``binary=True``); returns (n_states, n_arcs, words)."""
    arcs, finals, start, words = build_lg(lexicon, lm, lm_weight,
                                          word_score)
    t_arcs, t_finals, t_start, n_states = compose_ctc(
        arcs, finals, start, n_tokens)
    if binary:
        by_src: Dict[int, list] = {}
        for src, dst, il, ol, w in t_arcs:
            by_src.setdefault(src, []).append((il, ol, w, dst))
        StdFst.from_parts(t_start, by_src, t_finals).write_binary(path_fst)
    else:
        lines = []
        # first arc line must carry the start state (StdFst convention)
        ordered = sorted(t_arcs, key=lambda a: a[0] != t_start)
        for src, dst, il, ol, w in ordered:
            lines.append(f"{src} {dst} {il} {ol} {w:.8f}")
        for st, w in t_finals.items():
            lines.append(f"{st} {w:.8f}")
        with open(path_fst, "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(path_words, "w") as f:
        f.write("<eps> 0\n")
        for i, w in enumerate(words):
            f.write(f"{w} {i + 1}\n")
    return n_states, len(t_arcs), words
