"""Text-only dataset for language model training.

The port's own copy of ``espresso_tpu/data/lm_dataset.py``, numpy only,
equal to JAX's batch for batch: one sentence per line in ``{split}.txt``,
encoded with the AsrDictionary, eos-appended targets with eos-led inputs,
bucketed fixed-shape batches (the ASR dataset's batching,
``data/batching.py``). ``LMBatching`` holds the batching and collation that
``LMTextDataset`` shares with the binarized ``LMBlockDataset``
(``data/indexed_dataset.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from espresso_tpu_torch.data.batching import bucket_batches, filter_by_size, quantile_buckets
from espresso_tpu_torch.data.dataset import AsrDataset, BatchSpec
from espresso_tpu_torch.data.dictionary import AsrDictionary


class LMBatching:
    """Batch specs over ``src_sizes`` and the collation of an LM batch; a
    subclass fills one row's target and input tokens (``_fill_row``)."""

    dict: AsrDictionary
    src_sizes: np.ndarray

    def __len__(self) -> int:
        return len(self.src_sizes)

    def make_batch_specs(
        self,
        max_tokens: Optional[int],
        max_sentences: Optional[int],
        num_buckets: int = 5,
        required_batch_size_multiple: int = 8,
        max_source_positions: int = 1024,
        max_target_positions: int = 1024,
        shuffle: bool = True,
        seed: int = 1,
        epoch: int = 1,
        tgt_pad_multiple: int = 32,
    ) -> List[BatchSpec]:
        if shuffle:
            indices = np.random.default_rng([seed, epoch]).permutation(len(self))
        else:
            indices = np.arange(len(self))
        indices = indices[np.argsort(self.src_sizes[indices], kind="stable")]
        indices, _ = filter_by_size(indices, self.src_sizes, max_source_positions)
        sizes = quantile_buckets(self.src_sizes[indices], min(num_buckets, max(len(indices), 1)))
        raw = bucket_batches(
            indices,
            self.src_sizes,
            sizes,
            max_tokens=max_tokens,
            max_sentences=max_sentences,
            required_batch_size_multiple=required_batch_size_multiple,
        )
        specs = []
        for chunk, bucket_len in raw:
            # the repeated tail indices are shape padding
            num_real = len(chunk)
            for r in range(len(chunk) - 1, 0, -1):
                if chunk[r] == chunk[r - 1]:
                    num_real -= 1
                else:
                    break
            specs.append(
                BatchSpec(indices=chunk, num_real=num_real, src_bucket=bucket_len, tgt_bucket=bucket_len)
            )
        return specs

    group_specs = staticmethod(AsrDataset.group_specs)

    def _fill_row(self, idx: int, target: np.ndarray, prev: np.ndarray, eos: int) -> int:
        """Write item ``idx``'s targets and inputs into the pad-filled rows
        ``target`` and ``prev`` (their length is the bucket's); returns the
        number of targets written."""
        raise NotImplementedError

    def collate(self, spec: BatchSpec, epoch: int = 1) -> Dict[str, Any]:
        B, U = len(spec.indices), spec.tgt_bucket
        pad, eos = self.dict.pad(), self.dict.eos()
        target = np.full((B, U), pad, dtype=np.int32)
        prev = np.full((B, U), pad, dtype=np.int32)
        tgt_lengths = np.zeros(B, dtype=np.int32)
        for row, idx in enumerate(spec.indices):
            tgt_lengths[row] = self._fill_row(int(idx), target[row], prev[row], eos)
        weight = (np.arange(B) < spec.num_real).astype(np.float32)
        return {
            "utt_ids": [str(int(i)) for i in spec.indices],
            "target": target,
            "prev_output_tokens": prev,
            "tgt_lengths": tgt_lengths,
            "src_lengths": tgt_lengths.copy(),
            "weight": weight,
            "ntokens": int((tgt_lengths * weight).sum()),
            "nsentences": spec.num_real,
        }

    def collate_group(self, group: List[BatchSpec], epoch: int = 1) -> Dict[str, Any]:
        parts = [self.collate(s, epoch) for s in group]
        out: Dict[str, Any] = {}
        for key in ("target", "prev_output_tokens", "tgt_lengths", "src_lengths", "weight"):
            out[key] = np.stack([p[key] for p in parts])
        out["utt_ids"] = [p["utt_ids"] for p in parts]
        out["ntokens"] = sum(p["ntokens"] for p in parts)
        out["nsentences"] = sum(p["nsentences"] for p in parts)
        return out


class LMTextDataset(LMBatching):
    def __init__(self, path: str, dictionary: AsrDictionary, tokenizer=None):
        self.dict = dictionary
        self.sentences: List[np.ndarray] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if tokenizer is not None:
                    line = tokenizer.encode(line)
                self.sentences.append(dictionary.encode_line(line, append_eos=True))
        self.src_sizes = np.array([len(s) for s in self.sentences], dtype=np.int64)
        self.tgt_sizes = self.src_sizes

    def _fill_row(self, idx, target, prev, eos):
        sent = self.sentences[idx][: len(target)]
        n = len(sent)
        target[:n] = sent
        prev[0] = eos
        prev[1:n] = sent[: n - 1]
        return n
