"""WER/CER scoring with alignment printing and output filters.

The port's own copy of ``espresso_tpu/tools/wer.py`` (``edit_distance``,
``aligned_print``, ``Scorer``), with the same counter keys and the same
``aligned_results.txt`` format, the character counts on the port's native
edit counts (``clib/edit_distance.cpp``; the NumPy alignment where no
compiler is found). Host code: no torch.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[np.ndarray, Dict[str, int]]:
    """Levenshtein alignment. Returns (steps, counter) where counter has keys
    words/corr/sub/ins/del (reference espresso/tools/utils.py:265-340)."""
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), dtype=np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            ins = dist[i, j - 1] + 1
            dele = dist[i - 1, j] + 1
            dist[i, j] = min(sub, ins, dele)
    # backtrace
    steps: List[str] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] and ref[i - 1] == hyp[j - 1]:
            steps.append("corr")
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + 1:
            steps.append("sub")
            i, j = i - 1, j - 1
        elif j > 0 and dist[i, j] == dist[i, j - 1] + 1:
            steps.append("ins")
            j = j - 1
        else:
            steps.append("del")
            i = i - 1
    steps.reverse()
    counter = Counter(steps)
    counts = {
        "words": n,
        "corr": counter["corr"],
        "sub": counter["sub"],
        "ins": counter["ins"],
        "del": counter["del"],
        "steps": steps,
    }
    return dist, counts


def aligned_print(ref: Sequence[str], hyp: Sequence[str], steps: List[str]) -> str:
    """Produce the aligned REF/HYP/STP display (utils.py:343-424 format)."""
    ref_out, hyp_out, stp_out = [], [], []
    i = j = 0
    for step in steps:
        if step == "corr" or step == "sub":
            r, h = ref[i], hyp[j]
            i += 1
            j += 1
            tag = " " if step == "corr" else "S"
        elif step == "ins":
            r, h = "*" * len(hyp[j]), hyp[j]
            j += 1
            tag = "I"
        else:  # del
            r, h = ref[i], "*" * len(ref[i])
            i += 1
            tag = "D"
        width = max(len(r), len(h), 1)
        ref_out.append(r.ljust(width))
        hyp_out.append(h.ljust(width))
        stp_out.append(tag.ljust(width))
    return (
        "REF: " + " ".join(ref_out) + "\n"
        "HYP: " + " ".join(hyp_out) + "\n"
        "STP: " + " ".join(stp_out) + "\n"
    )


class Scorer:
    """Accumulating WER/CER scorer (espresso/tools/wer.py:16).

    ``wer_output_filter`` is a file of sed-like rules applied to both ref and
    hyp before scoring (reference :31-51): lines of ``s/x/y/g`` substitutions
    or bare tokens to delete.
    """

    def __init__(self, dictionary=None, wer_output_filter: Optional[str] = None):
        self.dictionary = dictionary
        self.filters: List[Tuple[str, str]] = []
        if wer_output_filter:
            with open(wer_output_filter, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    if line.startswith("s/"):
                        parts = line.split("/")
                        self.filters.append((parts[1], parts[2]))
                    else:
                        self.filters.append((r"\s" + re.escape(line) + r"\s", " "))
        self.reset()

    def reset(self) -> None:
        self.char_counter: Counter = Counter()
        self.word_counter: Counter = Counter()
        self.results = ""
        self.aligned_results = ""
        self.num_utts = 0

    def _char_counts_native(self, ref_chars, pred_chars):
        try:
            from espresso_tpu_torch.clib import batched_edit_counts
        except Exception:
            return None
        vocab: Dict[str, int] = {}

        def ids(seq):
            return [vocab.setdefault(c, len(vocab)) for c in seq]

        out = batched_edit_counts([ids(ref_chars)], [ids(pred_chars)])
        if out is None:
            return None
        corr, sub, ins, dele = (int(v) for v in out[0])
        return {
            "words": len(ref_chars),
            "corr": corr,
            "sub": sub,
            "ins": ins,
            "del": dele,
        }

    def _filter(self, text: str) -> str:
        padded = f" {text} "
        for pat, repl in self.filters:
            padded = re.sub(pat, repl, padded)
        return " ".join(padded.split())

    def add_prediction(self, utt_id: str, pred: str) -> None:
        self.results += f"{utt_id} {pred}\n"

    def add_evaluation(self, utt_id: str, ref: str, pred: str) -> None:
        self.num_utts += 1
        ref, pred = self._filter(ref), self._filter(pred)
        # char-level — native batched counts when the C++ lib is available
        # (clib/edit_distance.cpp, the libnat replacement)
        ref_chars = list(" ".join(ref.split()))
        pred_chars = list(" ".join(pred.split()))
        ccounts = self._char_counts_native(ref_chars, pred_chars)
        if ccounts is None:
            _, ccounts = edit_distance(ref_chars, pred_chars)
        for k in ("words", "corr", "sub", "ins", "del"):
            self.char_counter[k] += ccounts[k]
        # word-level
        ref_words, pred_words = ref.split(), pred.split()
        _, wcounts = edit_distance(ref_words, pred_words)
        for k in ("words", "corr", "sub", "ins", "del"):
            self.word_counter[k] += wcounts[k]
        self.aligned_results += f"{utt_id}\n"
        self.aligned_results += aligned_print(ref_words, pred_words, wcounts["steps"])
        wer = (
            100.0
            * (wcounts["sub"] + wcounts["ins"] + wcounts["del"])
            / max(wcounts["words"], 1)
        )
        self.aligned_results += f"WER: {wer:.2f}%\n\n"

    # -- aggregate metrics --------------------------------------------------
    def tot_word_error(self) -> int:
        return (
            self.word_counter["sub"]
            + self.word_counter["ins"]
            + self.word_counter["del"]
        )

    def tot_word_count(self) -> int:
        return self.word_counter["words"]

    def tot_char_error(self) -> int:
        return (
            self.char_counter["sub"]
            + self.char_counter["ins"]
            + self.char_counter["del"]
        )

    def tot_char_count(self) -> int:
        return self.char_counter["words"]

    def wer(self) -> float:
        return 100.0 * self.tot_word_error() / max(self.tot_word_count(), 1)

    def cer(self) -> float:
        return 100.0 * self.tot_char_error() / max(self.tot_char_count(), 1)

    def result_string(self) -> str:
        return (
            f"WER={self.wer():.2f}%, Sub={100.0 * self.word_counter['sub'] / max(self.tot_word_count(), 1):.2f}%, "
            f"Ins={100.0 * self.word_counter['ins'] / max(self.tot_word_count(), 1):.2f}%, "
            f"Del={100.0 * self.word_counter['del'] / max(self.tot_word_count(), 1):.2f}%"
        )
