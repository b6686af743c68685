"""Batch packing: dynamic token-budget batching and fixed-shape bucketing.

The port's own copy of ``espresso_tpu/data/batching.py``; its native
packing loop is the port's ``clib`` (``batching.cpp``), with the NumPy loop
where no compiler is found.

A rebuild of the reference batching stack:
  * ``batch_by_size`` — NumPy port of the semantics of the Cython
    ``batch_by_size_vec`` (fairseq/data/data_utils_fast.pyx): greedy packing of
    length-sorted indices under ``max_tokens``/``max_sentences`` with batch
    sizes rounded to a multiple.
  * ``quantile_buckets`` + ``bucket_batches`` — fixed-shape bucketed batching
    (the reference's TPU path: FeatBucketPadLengthDataset,
    espresso/data/asr_bucket_pad_length_dataset.py:11) promoted to the
    default: every emitted batch has one of ``num_buckets`` padded shapes.

All functions are pure NumPy and operate on index arrays (host-side, cheap
even for 960h-scale manifests).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def batch_by_size(
    indices: np.ndarray,
    num_tokens_vec: np.ndarray,
    max_tokens: Optional[int] = None,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 1,
) -> List[np.ndarray]:
    """Greedy packing of (pre-ordered) indices into batches.

    Semantics match fairseq data_utils_fast.pyx batch_by_size_vec: a batch is
    closed when adding the next item would exceed max_tokens (tokens counted as
    batch_len * max_item_len) or max_sentences; overflowing batches are trimmed
    to the largest multiple of `required_batch_size_multiple` below the
    overflow point (when > multiple).
    """
    indices = np.asarray(indices)
    num_tokens_vec = np.asarray(num_tokens_vec)
    assert indices.shape == num_tokens_vec.shape
    max_tokens = max_tokens if max_tokens is not None else -1
    max_sentences = max_sentences if max_sentences is not None else -1
    bsz_mult = required_batch_size_multiple

    # native fast path (clib/batching.cpp — the reference's Cython hot
    # loop); exact same semantics, ~100x at million-utterance manifests
    from espresso_tpu_torch.clib import batching_lib

    lib = batching_lib()
    if lib is not None and len(indices) > 0:
        sizes = np.ascontiguousarray(num_tokens_vec, dtype=np.int64)
        offsets = np.zeros(len(indices) + 1, np.int64)
        nb = lib.batch_by_size_fast(
            sizes,
            len(indices),
            int(max_tokens),
            int(max_sentences),
            int(bsz_mult),
            offsets,
        )
        return [
            indices[offsets[i] : offsets[i + 1]] for i in range(int(nb))
        ]

    batches: List[np.ndarray] = []
    start = 0
    tail_max = 0
    n = len(indices)
    pos = 0
    while pos < n:
        tail_max = max(tail_max, int(num_tokens_vec[pos]))
        sent_count = pos - start + 1
        overflow = (
            max_tokens >= 0 and sent_count * tail_max > max_tokens
        ) or (max_sentences >= 0 and sent_count > max_sentences)
        if overflow:
            batch_len = sent_count - 1
            if batch_len > bsz_mult:
                batch_len -= batch_len % bsz_mult
            if batch_len == 0:
                # single item exceeds budget: emit it alone
                batches.append(indices[start : start + 1])
                start = pos + 1
                tail_max = 0
                pos += 1
                continue
            batches.append(indices[start : start + batch_len])
            start = start + batch_len
            tail_max = int(num_tokens_vec[start:pos + 1].max())
        pos += 1
    if start < n:
        batches.append(indices[start:])
    return batches


def quantile_buckets(lengths: np.ndarray, num_buckets: int) -> np.ndarray:
    """Choose ``num_buckets`` boundary lengths covering the length distribution.

    Returns sorted unique bucket sizes; every utterance is padded up to the
    smallest bucket >= its length (reference mechanism: fairseq
    BucketPadLengthDataset via np.percentile).
    """
    lengths = np.asarray(lengths)
    pct = np.linspace(100.0 / num_buckets, 100.0, num_buckets)
    sizes = np.unique(np.percentile(lengths, pct, method="lower").astype(np.int64))
    sizes[-1] = lengths.max()
    return sizes


def assign_buckets(lengths: np.ndarray, bucket_sizes: np.ndarray) -> np.ndarray:
    """Index of the smallest bucket that fits each length."""
    return np.searchsorted(bucket_sizes, np.asarray(lengths), side="left")


def bucket_batches(
    indices: np.ndarray,
    src_lengths: np.ndarray,
    bucket_sizes: np.ndarray,
    max_tokens: Optional[int] = None,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 8,
) -> List[Tuple[np.ndarray, int]]:
    """Fixed-shape batching: group indices per bucket, fixed batch size/bucket.

    Returns a list of (index_array, padded_src_len). Each bucket's batch size
    is the largest multiple of ``required_batch_size_multiple`` such that
    bsz * bucket_len <= max_tokens (floor 1). The final partial batch of each
    bucket is padded *up* by repeating its last index so every batch of a
    bucket has an identical shape (at most ``len(bucket_sizes)`` shapes,
    which bounds the kernels' instances and the allocator's sizes). Repeated indices are flagged by the
    iterator as non-contributing (weight 0) downstream.
    """
    indices = np.asarray(indices)
    src_lengths = np.asarray(src_lengths)
    which = assign_buckets(src_lengths[indices], bucket_sizes)
    out: List[Tuple[np.ndarray, int]] = []
    for b, bucket_len in enumerate(bucket_sizes):
        members = indices[which == b]
        if len(members) == 0:
            continue
        if max_tokens is not None:
            bsz = max(int(max_tokens) // int(bucket_len), 1)
            if bsz > required_batch_size_multiple:
                bsz -= bsz % required_batch_size_multiple
        else:
            bsz = max_sentences or len(members)
        if max_sentences is not None:
            bsz = min(bsz, max_sentences)
        for s in range(0, len(members), bsz):
            chunk = members[s : s + bsz]
            if len(chunk) < bsz:
                pad = np.full(bsz - len(chunk), chunk[-1], dtype=chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            out.append((chunk, int(bucket_len)))
    return out


def filter_by_size(
    indices: np.ndarray,
    src_lengths: np.ndarray,
    max_positions: int,
    tgt_lengths: Optional[np.ndarray] = None,
    max_tgt_positions: Optional[int] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Drop indices whose lengths exceed limits; return (kept, ignored_list)."""
    indices = np.asarray(indices)
    keep = src_lengths[indices] <= max_positions
    if tgt_lengths is not None and max_tgt_positions is not None:
        keep &= tgt_lengths[indices] <= max_tgt_positions
    ignored = indices[~keep].tolist()
    return indices[keep], ignored
