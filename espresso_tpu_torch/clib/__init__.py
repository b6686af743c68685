"""Native host-side helpers (C++ via ctypes).

The port's own copy of ``espresso_tpu/clib`` without the FST decoder:
``batching.cpp`` (the batch packing loop of ``data/batching.py``) and
``edit_distance.cpp`` (batched edit counts for WER scoring). Host code, not
device kernels. Each library builds with ``g++`` at first use into
``espresso_tpu_torch/csrc/build/clib/<hash>/`` (listed in ``.gitignore``),
keyed on its source and flags, and loads with ``ctypes``; where no compiler
is found the callers keep their NumPy loops (``batch_by_size``) or get
``None`` (``batched_edit_counts``), as in the reference. ``native_paths()``
says which libraries loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_CLIB_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_CLIB_DIR), "csrc", "build", "clib")
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_cache: dict = {}


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    if name in _cache:
        return _cache[name]
    src = os.path.join(_CLIB_DIR, f"{name}.cpp")
    try:
        with open(src, "rb") as f:
            key = hashlib.sha256(" ".join(_GXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
        out_dir = os.path.join(_BUILD_DIR, key)
        so = os.path.join(out_dir, f"lib{name}.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            # compile to a temporary name and rename: a worker building at
            # the same time never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            try:
                subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, src], check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning("native %s unavailable (%s); using NumPy fallback", name, e)
        lib = None
    _cache[name] = lib
    return lib


def native_paths() -> Dict[str, bool]:
    """Which native libraries loaded (built at first use): name -> bool."""
    return {"batching": batching_lib() is not None, "edit_distance": edit_distance_lib() is not None}


def edit_distance_lib() -> Optional[ctypes.CDLL]:
    lib = _build_and_load("edit_distance")
    if lib is not None and not getattr(lib, "_configured", False):
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.batched_edit_counts.argtypes = [
            i32p,
            i32p,
            i32p,
            i32p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            i32p,
        ]
        lib.batched_edit_counts.restype = None
        lib._configured = True
    return lib


def batched_edit_counts(
    refs: list, hyps: list
) -> Optional[np.ndarray]:
    """Batched (corr, sub, ins, del) counts over int-token sequences.
    Returns [B, 4] or None when the native lib is unavailable."""
    lib = edit_distance_lib()
    if lib is None:
        return None
    B = len(refs)
    max_ref = max((len(r) for r in refs), default=1) or 1
    max_hyp = max((len(h) for h in hyps), default=1) or 1
    ref_arr = np.full((B, max_ref), -1, np.int32)
    hyp_arr = np.full((B, max_hyp), -1, np.int32)
    ref_lens = np.zeros(B, np.int32)
    hyp_lens = np.zeros(B, np.int32)
    for b, (r, h) in enumerate(zip(refs, hyps)):
        ref_arr[b, : len(r)] = r
        hyp_arr[b, : len(h)] = h
        ref_lens[b] = len(r)
        hyp_lens[b] = len(h)
    out = np.zeros((B, 4), np.int32)
    lib.batched_edit_counts(
        np.ascontiguousarray(ref_arr),
        ref_lens,
        np.ascontiguousarray(hyp_arr),
        hyp_lens,
        B,
        max_ref,
        max_hyp,
        out,
    )
    return out


def batching_lib() -> Optional[ctypes.CDLL]:
    lib = _build_and_load("batching")
    if lib is not None and not getattr(lib, "_configured", False):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.batch_by_size_fast.argtypes = [
            i64p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            i64p,
        ]
        lib.batch_by_size_fast.restype = ctypes.c_int64
        lib._configured = True
    return lib
