"""Pure-CTC prefix beam search with optional RNNLM shallow fusion.

The port's copy of ``lasr_tpu/decode/ctc_bs.py`` (numpy and Python on the
host; the port imports nothing of ``lasr_tpu``).  ``rnn_lm`` is the
port's ``modules.rnn.RNNLM``: its ``predict`` returns the log-probs on
the LM's device, copied to the host once per call (``_host``), as
``lasr_tpu``'s ``np.asarray`` copies JAX's.

Behavioral port of ``lasr/decode/ctc_bs_decoder.py:12-132`` (the classic
Graves prefix beam search over a (T, V) probability matrix with p_blank /
p_no_blank bookkeeping and per-prefix LM state).  This decoder is host-side
by design in the reference too — it operates on an already-computed CTC
posterior matrix, so the GPU does one encoder+CTC pass and the light DP
runs on numpy.  (The production joint decoder, decode/beam.py,
is the fully on-device path.)
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Tuple

import numpy as np

NEG_INF = -float("inf")


def _host(x) -> np.ndarray:
    """An LM's log-probs as a float32 numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _logsumexp(*args: float) -> float:
    m = max(args)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(a - m) for a in args))


class CTC_Decoder:
    def __init__(self, beam_size: int, ctc_beam: int = 15, blank: int = 0,
                 sos: int = 0, rnn_lm=None, lm_rate: float = 0.0):
        self.beam_size = beam_size
        self.ctc_beam = ctc_beam
        self.blank = blank
        self.sos = sos
        self.rnn_lm = rnn_lm
        self.lm_rate = lm_rate if rnn_lm is not None else 0.0

    def decode_problike(self, probs: np.ndarray, do_log: bool = False
                        ) -> List[Tuple[tuple, float]]:
        """probs: (T, V) posteriors (or raw probs with do_log=True).
        Returns the N-best [(prefix tuple incl. leading sos, log-prob)]."""
        T, V = probs.shape
        lp = np.log(np.maximum(probs, 1e-300)) if do_log else probs
        topk = self.ctc_beam if self.ctc_beam else V

        if self.rnn_lm is not None:
            state0, lm0 = self.rnn_lm.predict(np.array([self.sos]), None)
            lm0 = _host(lm0)[-1]
        else:
            state0, lm0 = None, None
        # prefix -> [p_blank, p_no_blank, lm_state, lm_scores]
        beam = [((self.sos,), [0.0, NEG_INF, state0, lm0])]

        for t in range(T):
            order = np.argsort(lp[t])[::-1][:topk]
            next_beam = defaultdict(lambda: [NEG_INF, NEG_INF, None, None])
            for prefix, (p_b, p_nb, lm_state, prefix_lm) in beam:
                for s in order:
                    p = lp[t, s]
                    if s == self.blank:
                        entry = next_beam[prefix]
                        entry[0] = _logsumexp(entry[0], p_b + p, p_nb + p)
                        entry[2], entry[3] = lm_state, prefix_lm
                        continue
                    end_t = prefix[-1] if prefix else None
                    n_prefix = prefix + (int(s),)
                    q = self.lm_rate * float(prefix_lm[s]) \
                        if prefix_lm is not None else 0.0
                    entry = next_beam[n_prefix]
                    if s != end_t:
                        entry[1] = _logsumexp(entry[1], p_b + p + q,
                                              p_nb + p + q)
                    else:
                        # repeated label must be blank-separated
                        entry[1] = _logsumexp(entry[1], p_b + p + q)
                        same = next_beam[prefix]
                        same[1] = _logsumexp(same[1], p_nb + p)
                        same[2], same[3] = lm_state, prefix_lm
                    entry[2] = lm_state  # LM state advances lazily below

            beam = sorted(next_beam.items(),
                          key=lambda kv: _logsumexp(kv[1][0], kv[1][1]),
                          reverse=True)[: self.beam_size]
            if self.rnn_lm is not None:
                for prefix, entry in beam:
                    if entry[3] is None:
                        state, scores = self.rnn_lm.predict(
                            np.array([prefix[-1]]), entry[2])
                        entry[2] = state
                        entry[3] = _host(scores)[-1]

        return [(prefix, _logsumexp(e[0], e[1])) for prefix, e in beam]
