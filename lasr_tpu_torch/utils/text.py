"""Host-side text metrics (counterpart of ``lasr_tpu/utils/text.py``)."""

from __future__ import annotations

from typing import Hashable, Sequence


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
