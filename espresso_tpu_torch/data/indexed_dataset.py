"""Mmap-binarized token stream + token-block packing for LM training.

The port's own copy of ``espresso_tpu/data/indexed_dataset.py`` (fairseq's
``MMapIndexedDataset`` and ``TokenBlockDataset`` semantics), numpy only:
text is binarized once into a flat little-endian int32 token stream
(``{prefix}.bin``) with an int64 sentence-offset index (``{prefix}.idx``),
memory-mapped at load and packed into training blocks, so training memory
is O(batch), not O(corpus). Both packages write and read the same bytes, so
a corpus binarized by either trains in both.

Formats:
  ``{prefix}.bin``  raw int32 tokens, every sentence eos-terminated
  ``{prefix}.idx``  npz: magic, version, offsets (int64 [N+1] into .bin)
"""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np

from espresso_tpu_torch.data.lm_dataset import LMBatching

MAGIC = "ESPTPU-IDX"
VERSION = 1


def write_binarized(prefix: str, token_seqs: Iterable[np.ndarray]) -> int:
    """Stream token sequences to {prefix}.bin/.idx; returns #sentences.
    Constant memory in corpus size: only the int64 offsets stay in RAM."""
    offsets = [0]
    total = 0
    with open(prefix + ".bin", "wb") as f:
        for seq in token_seqs:
            arr = np.asarray(seq, dtype="<i4")
            f.write(arr.tobytes())
            total += len(arr)
            offsets.append(total)
    np.savez(prefix + ".idx", magic=MAGIC, version=VERSION, offsets=np.asarray(offsets, dtype=np.int64))
    # np.savez appends .npz: keep the documented extension
    os.replace(prefix + ".idx.npz", prefix + ".idx")
    return len(offsets) - 1


class MMapTokenDataset:
    """Memory-mapped flat token stream with sentence offsets."""

    def __init__(self, prefix: str):
        with open(prefix + ".idx", "rb") as f:
            idx = np.load(f)
            assert str(idx["magic"]) == MAGIC, prefix
            self.offsets = idx["offsets"]
        self.tokens = np.memmap(prefix + ".bin", dtype="<i4", mode="r")
        assert len(self.tokens) == int(self.offsets[-1]), (len(self.tokens), int(self.offsets[-1]))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def sizes(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)

    @property
    def total_tokens(self) -> int:
        return int(self.offsets[-1])

    def sentence(self, i: int) -> np.ndarray:
        return np.asarray(self.tokens[int(self.offsets[i]) : int(self.offsets[i + 1])])


def token_block_slices(sizes: np.ndarray, block_size: int, break_mode: str = "none") -> np.ndarray:
    """[num_blocks, 2] (start, end) slices into the flat token stream:

    ``none``      fixed ``block_size`` slices ignoring sentence bounds
    ``complete``  greedy whole-sentence packing up to ``block_size`` (an
                  oversized sentence becomes its own block)
    ``eos``       one sentence per block"""
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if break_mode == "none":
        assert block_size > 0
        starts = np.arange(0, total, block_size, dtype=np.int64)
        ends = np.minimum(starts + block_size, total)
        return np.stack([starts, ends], axis=1)
    if break_mode == "eos":
        ends = np.cumsum(sizes)
        return np.stack([ends - sizes, ends], axis=1)
    if break_mode == "complete":
        assert block_size > 0
        slices: List[List[int]] = []
        cur_start = cur_len = pos = 0
        for sz in sizes:
            sz = int(sz)
            if cur_len > 0 and cur_len + sz > block_size:
                slices.append([cur_start, cur_start + cur_len])
                cur_start, cur_len = pos, 0
            cur_len += sz
            pos += sz
        if cur_len > 0:
            slices.append([cur_start, cur_start + cur_len])
        return np.asarray(slices, dtype=np.int64).reshape(-1, 2)
    raise ValueError(f"unknown break_mode {break_mode!r}")


class LMBlockDataset(LMBatching):
    """Token-block LM dataset over an mmap stream (``LMTextDataset``'s
    interface). ``prev_output_tokens`` for a block [s, e) is the stream at
    [s-1, e-1) (eos at the very first position): context flows across block
    boundaries as in fairseq's ``TokenBlockDataset``."""

    def __init__(self, prefix: str, dictionary, block_size: int = 512, break_mode: str = "none"):
        self.dict = dictionary
        self.data = MMapTokenDataset(prefix)
        self.block_size = block_size
        self.break_mode = break_mode
        self.slices = token_block_slices(self.data.sizes, block_size, break_mode)
        self.src_sizes = (self.slices[:, 1] - self.slices[:, 0]).astype(np.int64)
        self.tgt_sizes = self.src_sizes

    def _fill_row(self, idx, target, prev, eos):
        toks = self.data.tokens
        s, e = (int(x) for x in self.slices[idx])
        e = min(e, s + len(target))
        n = e - s
        target[:n] = toks[s:e]
        if s == 0:
            prev[0] = eos
            prev[1:n] = toks[: e - 1]
        else:
            prev[:n] = toks[s - 1 : e - 1]
        return n
