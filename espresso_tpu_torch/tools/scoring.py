"""Scoring: corpus/sentence BLEU and chrF.

The port's own copy of ``espresso_tpu/tools/scoring.py``: BLEU with the
libbleu semantics (cumulative clipped n-gram counts up to order 4 over the
corpus, geometric mean, brevity penalty exp(1 - r/c) when c < r), add-k
smoothed sentence BLEU and corpus chrF. Host code: no torch.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Sequence


def _ngrams(tokens: Sequence, order: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + order]) for i in range(len(tokens) - order + 1)
    )


@dataclass
class BleuStat:
    order: int = 4
    reflen: int = 0
    predlen: int = 0
    match: List[int] = field(default_factory=list)
    count: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.match:
            self.match = [0] * self.order
        if not self.count:
            self.count = [0] * self.order


class BleuScorer:
    """Corpus BLEU accumulator (fairseq/scoring/bleu.py Scorer API:
    add(ref, pred) then score()/result_string())."""

    def __init__(self, max_order: int = 4):
        self.max_order = max_order
        self.stat = BleuStat(order=max_order)

    def reset(self) -> None:
        self.stat = BleuStat(order=self.max_order)

    def add(self, ref: Sequence, pred: Sequence) -> None:
        self.stat.reflen += len(ref)
        self.stat.predlen += len(pred)
        for n in range(1, self.max_order + 1):
            rg = _ngrams(ref, n)
            pg = _ngrams(pred, n)
            self.stat.match[n - 1] += sum(
                min(c, rg.get(g, 0)) for g, c in pg.items()
            )
            self.stat.count[n - 1] += max(len(pred) - n + 1, 0)

    def precisions(self) -> List[float]:
        return [
            m / c if c > 0 else 0.0
            for m, c in zip(self.stat.match, self.stat.count)
        ]

    def brevity(self) -> float:
        if self.stat.predlen == 0:
            return 0.0
        if self.stat.predlen >= self.stat.reflen:
            return 1.0
        return math.exp(1.0 - self.stat.reflen / self.stat.predlen)

    def score(self) -> float:
        ps = self.precisions()
        if min(ps) <= 0.0:
            return 0.0
        log_avg = sum(math.log(p) for p in ps) / self.max_order
        return 100.0 * self.brevity() * math.exp(log_avg)

    def result_string(self) -> str:
        ps = self.precisions()
        return (
            f"BLEU{self.max_order} = {self.score():.2f}, "
            + "/".join(f"{100 * p:.1f}" for p in ps)
            + f" (BP={self.brevity():.3f}, ratio={self.stat.predlen / max(self.stat.reflen, 1):.3f}, "
            f"syslen={self.stat.predlen}, reflen={self.stat.reflen})"
        )


def sentence_bleu(
    ref: Sequence, pred: Sequence, max_order: int = 4, smooth: float = 1.0
) -> float:
    """Add-k smoothed sentence BLEU (the usual per-sentence variant)."""
    if len(pred) == 0:
        return 0.0
    log_avg = 0.0
    for n in range(1, max_order + 1):
        rg = _ngrams(ref, n)
        pg = _ngrams(pred, n)
        match = sum(min(c, rg.get(g, 0)) for g, c in pg.items())
        count = max(len(pred) - n + 1, 0)
        p = (match + smooth) / (count + smooth)
        log_avg += math.log(p) / max_order
    bp = 1.0 if len(pred) >= len(ref) else math.exp(1.0 - len(ref) / len(pred))
    return 100.0 * bp * math.exp(log_avg)


class ChrFScorer:
    """Corpus chrF (fairseq/scoring/chrf.py semantics: character n-grams up
    to 6, beta=2, F-score of corpus-accumulated precision/recall)."""

    def __init__(self, order: int = 6, beta: float = 2.0):
        self.order = order
        self.beta = beta
        self.match = [0] * order
        self.pred_count = [0] * order
        self.ref_count = [0] * order

    def add(self, ref: str, pred: str) -> None:
        ref_c = ref.replace(" ", "")
        pred_c = pred.replace(" ", "")
        for n in range(1, self.order + 1):
            rg = _ngrams(ref_c, n)
            pg = _ngrams(pred_c, n)
            self.match[n - 1] += sum(min(c, rg.get(g, 0)) for g, c in pg.items())
            self.pred_count[n - 1] += max(len(pred_c) - n + 1, 0)
            self.ref_count[n - 1] += max(len(ref_c) - n + 1, 0)

    def score(self) -> float:
        precs = [
            m / c if c else 0.0 for m, c in zip(self.match, self.pred_count)
        ]
        recs = [
            m / c if c else 0.0 for m, c in zip(self.match, self.ref_count)
        ]
        avg_p = sum(precs) / self.order
        avg_r = sum(recs) / self.order
        b2 = self.beta**2
        if avg_p + avg_r == 0:
            return 0.0
        return 100.0 * (1 + b2) * avg_p * avg_r / (b2 * avg_p + avg_r)

    def result_string(self) -> str:
        return f"chrF{self.beta:g} = {self.score():.2f}"
