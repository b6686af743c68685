"""Pure-Python Kaldi scp/ark matrix and vector IO.

The port's own copy of ``espresso_tpu/data/kaldi_io.py``.

A replacement for the ``kaldi_io`` pip package the reference depends on
(espresso/data/feat_text_dataset.py:128-130 reads ``feats.scp`` matrices;
espresso/dump_posteriors.py:147-180 writes matrices into a ``copy-matrix`` pipe).

Supports Kaldi rx/wx-filename conventions:
  * ``file.ark:12345``      — seek offset into an archive
  * ``command args |``      — read from a shell pipe (rxfilename)
  * ``| command args``      — write into a shell pipe (wxfilename)
  * ``-``                   — stdin/stdout

Binary formats handled: FM/DM (float/double matrix), FV/DV (vectors), and
compressed matrices CM (uint8 + per-column percentile headers) and CM2 (uint16).
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np


def open_or_fd(rx_or_wx: str, mode: str = "rb") -> BinaryIO:
    """Open an rx/wx-filename: plain file, `file:offset`, pipe, or '-'."""
    if rx_or_wx == "-":
        return os.fdopen(os.dup(0 if "r" in mode else 1), mode)
    if "r" in mode and rx_or_wx.rstrip().endswith("|"):
        proc = subprocess.Popen(
            rx_or_wx.rstrip().rstrip("|"), shell=True, stdout=subprocess.PIPE
        )
        return proc.stdout  # type: ignore[return-value]
    if "w" in mode and rx_or_wx.lstrip().startswith("|"):
        proc = subprocess.Popen(
            rx_or_wx.lstrip().lstrip("|"), shell=True, stdin=subprocess.PIPE
        )
        return proc.stdin  # type: ignore[return-value]
    offset = None
    path = rx_or_wx
    # split trailing :offset (but not Windows drive letters; kaldi style)
    if "r" in mode and ":" in rx_or_wx:
        head, _, tail = rx_or_wx.rpartition(":")
        if tail.isdigit() and os.path.exists(head):
            path, offset = head, int(tail)
    f = open(path, mode)
    if offset is not None:
        f.seek(offset)
    return f


def _read_token(f: BinaryIO) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if c == b"" or c == b" ":
            break
        tok += c
    return tok.decode()


def _expect_binary(f: BinaryIO) -> None:
    binary = f.read(2)
    if binary != b"\x00B":
        raise ValueError(f"expected Kaldi binary header \\0B, got {binary!r}")


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    assert size == b"\x04", f"bad int32 size byte {size!r}"
    return struct.unpack("<i", f.read(4))[0]


def _write_int32(f: BinaryIO, value: int) -> None:
    f.write(b"\x04")
    f.write(struct.pack("<i", value))


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------


def read_mat(rxfilename: str) -> np.ndarray:
    f = open_or_fd(rxfilename, "rb")
    try:
        return _read_mat_fd(f)
    finally:
        f.close()


def _read_mat_fd(f: BinaryIO) -> np.ndarray:
    _expect_binary(f)
    token = _read_token(f)
    if token in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dtype = np.float32 if token == "FM" else np.float64
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype=dtype)
        return data.reshape(rows, cols).astype(np.float32, copy=False)
    if token in ("CM", "CM2"):
        return _read_compressed_mat(f, token)
    raise ValueError(f"unsupported Kaldi matrix token {token!r}")


def _read_compressed_mat(f: BinaryIO, token: str) -> np.ndarray:
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if token == "CM2":
        data = np.frombuffer(f.read(2 * rows * cols), dtype=np.uint16).reshape(
            rows, cols
        )
        return (min_value + rng * data.astype(np.float32) / 65535.0).astype(
            np.float32
        )
    # CM: per-column percentile headers (4 uint16 each), then uint8 data col-major
    headers = np.frombuffer(f.read(8 * cols), dtype=np.uint16).reshape(cols, 4)
    pct = min_value + rng * headers.astype(np.float32) / 65535.0  # [cols, 4]
    p0, p25, p75, p100 = pct[:, 0], pct[:, 1], pct[:, 2], pct[:, 3]
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
    c = data.astype(np.float32)
    lo = p0[:, None] + (p25 - p0)[:, None] * (c / 64.0)
    mid = p25[:, None] + (p75 - p25)[:, None] * ((c - 64.0) / 128.0)
    hi = p75[:, None] + (p100 - p75)[:, None] * ((c - 192.0) / 63.0)
    out = np.where(c <= 64, lo, np.where(c <= 192, mid, hi))
    return np.ascontiguousarray(out.T).astype(np.float32)


def write_mat(f_or_wx, mat: np.ndarray, key: str = "") -> None:
    own = False
    if isinstance(f_or_wx, str):
        f = open_or_fd(f_or_wx, "wb")
        own = True
    else:
        f = f_or_wx
    try:
        if key:
            f.write((key + " ").encode())
        f.write(b"\x00B")
        mat = np.asarray(mat)
        if mat.dtype == np.float64:
            f.write(b"DM ")
        else:
            mat = mat.astype(np.float32, copy=False)
            f.write(b"FM ")
        _write_int32(f, mat.shape[0])
        _write_int32(f, mat.shape[1])
        f.write(mat.tobytes())
    finally:
        if own:
            f.close()


# ---------------------------------------------------------------------------
# Vectors (CMVN stats, state priors, alignments use int vectors)
# ---------------------------------------------------------------------------


def read_vec_flt(rxfilename: str) -> np.ndarray:
    f = open_or_fd(rxfilename, "rb")
    try:
        _expect_binary(f)
        token = _read_token(f)
        if token not in ("FV", "DV"):
            raise ValueError(f"unsupported vector token {token!r}")
        dim = _read_int32(f)
        dtype = np.float32 if token == "FV" else np.float64
        return np.frombuffer(f.read(dim * dtype().itemsize), dtype=dtype).astype(
            np.float32, copy=False
        )
    finally:
        f.close()


def read_vec_int(rxfilename: str) -> np.ndarray:
    """Read a Kaldi int32 vector (alignment format: per-element size bytes)."""
    f = open_or_fd(rxfilename, "rb")
    try:
        _expect_binary(f)
        dim = _read_int32(f)
        raw = np.frombuffer(f.read(dim * 5), dtype=np.uint8).reshape(dim, 5)
        assert (raw[:, 0] == 4).all(), "bad int-vector size bytes"
        return np.ascontiguousarray(raw[:, 1:5]).view(np.int32).reshape(dim)
    finally:
        f.close()


def write_vec_int(f_or_wx, vec: np.ndarray, key: str = "") -> None:
    """Write a Kaldi int32 vector (alignment format)."""
    own = False
    if isinstance(f_or_wx, str):
        f = open_or_fd(f_or_wx, "wb")
        own = True
    else:
        f = f_or_wx
    try:
        if key:
            f.write((key + " ").encode())
        f.write(b"\x00B")
        vec = np.asarray(vec, dtype=np.int32)
        _write_int32(f, vec.shape[0])
        out = np.empty((vec.shape[0], 5), dtype=np.uint8)
        out[:, 0] = 4
        out[:, 1:] = vec.reshape(-1, 1).view(np.uint8).reshape(-1, 4)
        f.write(out.tobytes())
    finally:
        if own:
            f.close()


def write_vec_flt(f_or_wx, vec: np.ndarray, key: str = "") -> None:
    own = False
    if isinstance(f_or_wx, str):
        f = open_or_fd(f_or_wx, "wb")
        own = True
    else:
        f = f_or_wx
    try:
        if key:
            f.write((key + " ").encode())
        f.write(b"\x00B")
        vec = np.asarray(vec, dtype=np.float32)
        f.write(b"FV ")
        _write_int32(f, vec.shape[0])
        f.write(vec.tobytes())
    finally:
        if own:
            f.close()


# ---------------------------------------------------------------------------
# Archive iteration (ark files with key-value streams)
# ---------------------------------------------------------------------------


def read_mat_ark(rx: str) -> Iterator[Tuple[str, np.ndarray]]:
    f = open_or_fd(rx, "rb")
    try:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key, _read_mat_fd(f)
    finally:
        f.close()


def read_scp(scp_path: str) -> Iterator[Tuple[str, str]]:
    with open(scp_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rx = line.partition(" ")
            yield key, rx
