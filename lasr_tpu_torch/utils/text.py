"""Host-side text metrics (counterpart of ``lasr_tpu/utils/text.py``):
edit distance, its (substitution, deletion, insertion) split and the
WER/CER accumulator of the decode CLI."""

from __future__ import annotations

from typing import Hashable, Sequence, Tuple


def edit_distance(ref: Sequence[Hashable], hyp: Sequence[Hashable]) -> int:
    """Levenshtein distance via the rolling-row DP."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            cur[j] = min(prev[j] + 1,              # deletion
                         cur[j - 1] + 1,           # insertion
                         prev[j - 1] + (r != h))   # substitution / match
        prev = cur
    return prev[-1]


def align_ops(ref: Sequence[Hashable], hyp: Sequence[Hashable]
              ) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) from a full DP backtrace."""
    n, m = len(ref), len(hyp)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        d[i][0] = i
    for j in range(1, m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]))
    subs = dels = ins = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                d[i][j] == d[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins


class ErrorRateAccumulator:
    """Streaming WER/CER accumulator over a decode run."""

    def __init__(self) -> None:
        self.errors = self.tokens = self.utts = 0
        self.subs = self.dels = self.ins = 0

    def add(self, ref: Sequence[Hashable], hyp: Sequence[Hashable]) -> int:
        subs, dels, ins = align_ops(ref, hyp)
        dist = subs + dels + ins
        self.errors += dist
        self.tokens += len(ref)
        self.utts += 1
        self.subs += subs
        self.dels += dels
        self.ins += ins
        return dist

    @property
    def rate(self) -> float:
        return self.errors / max(self.tokens, 1)

    def report(self) -> str:
        return (f"ER {100.0 * self.rate:.2f}% "
                f"[{self.errors}/{self.tokens}, {self.utts} utts, "
                f"sub {self.subs} del {self.dels} ins {self.ins}]")
