"""Fused relative-position self-attention (Hopper kernels).

Counterpart of ``espresso_tpu/ops/attention_kernels.py``. All functions take
the flattened-heads layout of the JAX call site: ``q_u, q_v, k, v``
[B, T, D], ``p`` [2T-1, D], ``key_valid`` [B, T] bool.

* Inference: ``rel_attention`` wraps ``csrc/rel_attention.cu`` (which
  replaces the Pallas ``rel_attention_fused``); ``rel_attention_reference``
  is its plain version (attention_kernels.py:106-128). The kernel keeps a
  query tile's scores in shared memory past its first two key tiles up to
  ``REL_ATTENTION_SHORT_MAX_T`` (1344); past it a long-row mode of the
  same kernel (two passes over the key tiles, no score row in shared
  memory) runs, up to ``REL_ATTENTION_MAX_T`` (4096), where it raises.
* Training: ``rel_attention_train`` is a ``torch.autograd.Function`` around
  ``rel_attention_train_fwd`` and ``rel_attention_train_bwd``, which wrap the
  two halves of ``csrc/rel_attention_train.cu`` (the Pallas
  ``rel_attention_train`` forward and backward, attention_kernels.py
  :444-678). The forward is the inference kernel's block
  (``csrc/rel_attention_fwd.cuh``) with its scores in registers for three
  key tiles, in shared memory up to ``REL_ATTENTION_TRAIN_SHORT_MAX_T``
  (1408) and in the long-row mode past it; the forward and the backward
  take T up to ``REL_ATTENTION_TRAIN_MAX_T`` (4096) and raise above it; it drops
  softmax weights with an in-kernel counter hash of (seed, batch item,
  head, query, key), replayed bit for bit by ``dropout_keep_mask``
  (attention_kernels.py:312-368); the backward recomputes scores, softmax
  and mask and returns all five input gradients.
  ``rel_attention_train_reference`` and
  ``rel_attention_train_backward_reference`` are the plain versions. The
  seed is an int32 tensor on the inputs' device (the TPU kernel reads it
  from SMEM), so a layer draws and passes it without a host sync.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, and counts its launches (``fn.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from espresso_tpu_torch.ops.masking import NEG_INF

HEAD_DIM = 64  # the kernels' only head width (the flagship's d = 512 / 8)
_SOURCES = ("rel_attention.cu", "rel_attention_fwd.cuh", "hopper_sm90.cuh")
_TRAIN_SOURCES = ("rel_attention_train.cu", "rel_attention_fwd.cuh", "hopper_sm90.cuh")
# library name -> its CUDA sources (with the headers they include)
LIBRARIES = {"rel_attention": _SOURCES, "rel_attention_train": _TRAIN_SOURCES}
# the dynamic shared memory a block may have on an H100
SMEM_LIMIT = 232448


def _fwd_smem_bytes(T: int, nr: int) -> int:
    """The dynamic shared memory of a block of ``csrc/rel_attention_fwd.cuh``
    at length T whose first ``nr`` key tiles keep their scores in registers
    (its ``smem_bytes<NR>``): 1024 bytes of alignment slack; q+u, q+v and a
    ring of two stages of three 8 KB tiles; 64 bytes of barriers; the f32
    key mask of the padded length; and, past those ``nr`` key tiles, 64 bf16
    score rows of the rest (plus 8 columns)."""
    tile, box = 64, 8192
    Tp = -(-T // tile) * tile
    rest = Tp - nr * tile
    return 1024 + (2 + 3 * 2) * box + 64 + 4 * Tp + (2 * tile * (rest + 8) if rest > 0 else 0)


def long_rows_smem_bytes(T: int) -> int:
    """The dynamic shared memory of a block of the long-row mode of
    ``csrc/rel_attention_fwd.cuh`` (its ``long_smem_bytes``): 1024 bytes of
    alignment slack; q+u, q+v and a ring of two stages of four 8 KB tiles
    (K, the p window, V); 64 bytes of barriers; the f32 key mask."""
    tile, box = 64, 8192
    return 1024 + (2 + 4 * 2) * box + 64 + 4 * (-(-T // tile) * tile)


def rel_attention_long_rows(T: int) -> bool:
    """Whether the inference kernel runs its long-row mode at length T: the
    scores of the key tiles past the first two would not fit in shared
    memory (the C entry's ``long_rows<2>``)."""
    return _fwd_smem_bytes(T, 2) > SMEM_LIMIT


def rel_attention_train_long_rows(T: int) -> bool:
    """The same for the train forward (``long_rows<FWD_NR = 3>``)."""
    return _fwd_smem_bytes(T, 3) > SMEM_LIMIT


def rel_attention_smem_bytes(T: int) -> int:
    """The dynamic shared memory of ``csrc/rel_attention.cu`` at length T
    (scores in registers for two key tiles; the long-row mode past them)."""
    return long_rows_smem_bytes(T) if rel_attention_long_rows(T) else _fwd_smem_bytes(T, 2)


def rel_attention_train_smem_bytes(T: int) -> int:
    """The dynamic shared memory of the train forward of
    ``csrc/rel_attention_train.cu`` at length T (scores in registers for
    three key tiles, ``FWD_NR``; the long-row mode past them)."""
    if rel_attention_train_long_rows(T):
        return long_rows_smem_bytes(T)
    return _fwd_smem_bytes(T, 3)


def _max_len(smem_bytes) -> int:
    return max(T for T in range(64, 4097, 64) if smem_bytes(T) <= SMEM_LIMIT)


# the longest T whose score rows fit in shared memory: the inference
# kernel's (1344) and the train forward's (1408); past them the long-row
# mode runs, up to the wrappers' limit (~164 s of audio at the flagship's
# 40 ms a frame), above which they raise
REL_ATTENTION_SHORT_MAX_T = _max_len(lambda T: _fwd_smem_bytes(T, 2))
REL_ATTENTION_TRAIN_SHORT_MAX_T = _max_len(lambda T: _fwd_smem_bytes(T, 3))
REL_ATTENTION_MAX_T = REL_ATTENTION_TRAIN_MAX_T = 4096


def rel_attention_reference(
    q_u: torch.Tensor,
    q_v: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,
    key_valid: torch.Tensor,
    H: int,
    scale: float,
) -> torch.Tensor:
    """Plain version: computes in the input dtype with an fp32 softmax."""
    B, T, D = q_u.shape
    d = D // H
    split = lambda x: x.reshape(B, T, H, d)
    pos = torch.arange(T, device=q_u.device)
    idx = ((T - 1) + pos[None, :] - pos[:, None]).clamp(0, p.shape[0] - 1)
    p_shift = p.reshape(-1, H, d)[idx]  # [T, T, H, d]
    ac = torch.einsum("bqhd,bkhd->bhqk", split(q_u), split(k))
    bd = torch.einsum("bqhd,qkhd->bhqk", split(q_v), p_shift)
    # scale rounds to the working dtype first, as a weakly typed JAX scalar
    scores = (ac + bd) * torch.tensor(scale, dtype=q_u.dtype, device=q_u.device)
    scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q_u.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, split(v)).reshape(B, T, D)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from espresso_tpu_torch.ops import cuda_build

    lib = cuda_build.load("rel_attention", _SOURCES)
    fn = lib.rel_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(q_u, q_v, k, v, p, key_valid, H, name="rel_attention"):
    B, T, D = q_u.shape
    dev = q_u.device
    for arg, x in (("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v), ("p", p)):
        if x.device != dev or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bf16 on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and aligned")
    for arg, x in (("q_v", q_v), ("k", k), ("v", v)):
        if x.shape != (B, T, D):
            raise ValueError(f"{name}: {arg} {tuple(x.shape)} != {(B, T, D)}")
    if p.shape != (2 * T - 1, D):
        raise ValueError(f"{name}: p {tuple(p.shape)} != {(2 * T - 1, D)}")
    if D != H * HEAD_DIM:
        raise ValueError(f"{name}: head dim {D // H} (kernel takes {HEAD_DIM})")
    if (
        key_valid.device != dev
        or key_valid.dtype != torch.bool
        or key_valid.shape != (B, T)
        or not key_valid.is_contiguous()
    ):
        raise ValueError(f"{name}: key_valid must be contiguous [B, T] bool")


def rel_attention(
    q_u: torch.Tensor,
    q_v: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,
    key_valid: torch.Tensor,
    H: int,
    scale: float,
) -> torch.Tensor:
    """Fused rel-pos self-attention; returns the [B, T, D] context (before
    the output projection). On the card: bf16 inputs, head width 64, T up
    to ``REL_ATTENTION_MAX_T`` (4096; past 1344 the kernel's long-row mode).
    ``rel_attention.launches`` counts kernel launches."""
    if q_u.device.type == "cpu":
        return rel_attention_reference(q_u, q_v, k, v, p, key_valid, H, scale)
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {q_u.device}")
    _check(q_u, q_v, k, v, p, key_valid, H)
    B, T, D = q_u.shape
    if T > REL_ATTENTION_MAX_T:
        raise ValueError(f"rel_attention: T={T} (the kernel takes T <= {REL_ATTENTION_MAX_T})")
    out = torch.empty_like(q_u)
    device = q_u.device.index  # a CUDA tensor's device always has its index
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _lib().rel_attention_bf16(
        q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        key_valid.data_ptr(), out.data_ptr(), B, T, H, float(scale), device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"rel_attention kernel launch failed at T={T}: CUDA error {rc}")
    rel_attention.launches += 1
    return out


rel_attention.launches = 0


# ---------------------------------------------------------------------------
# training: dropout hash, plain forward and backward, kernels, autograd
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B1
_HEAD_MUL = 0x27D4EB2F
_KEY_MUL = 0x165667B1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): the int32 wrapping
    multiply of the TPU kernel, in halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _imix(x: torch.Tensor) -> torch.Tensor:
    """The murmur3-style finalizer ``_imix`` (attention_kernels.py:326-333)
    on uint32 values held in int64 (a logical shift is a plain shift)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask_tile(
    seed: Union[int, torch.Tensor],
    item: Union[int, torch.Tensor],
    head: Union[int, torch.Tensor],
    Tq: int,
    Tk: int,
) -> torch.Tensor:
    """The dropout draw for (seed, item, head): int64 values in [0, 2^31),
    bit-equal to ``_keep_mask_tile`` (attention_kernels.py:336-362). ``item``
    and ``head`` broadcast against each other (e.g. [B, 1] and [1, H]); the
    result has their shape followed by [Tq, Tk]. The (seed, item, head)
    triple is finalized before the row index enters the stream."""
    dev = seed.device if isinstance(seed, torch.Tensor) else torch.device("cpu")
    as64 = lambda x: torch.as_tensor(x, device=dev).to(torch.int64) & _M32
    seed, item, head = as64(seed), as64(item), as64(head)
    x = _imix((seed + _mul32(item, _GOLD) + _mul32(head, _HEAD_MUL)) & _M32)
    q = torch.arange(Tq, device=dev, dtype=torch.int64)
    kk = torch.arange(Tk, device=dev, dtype=torch.int64)
    x = _imix((x[..., None] + _mul32(q, _GOLD)) & _M32)
    x = _imix(x[..., None] ^ _mul32(kk, _KEY_MUL))
    return x >> 1


def keep_threshold(rate: float) -> int:
    """A draw below this keeps its weight (attention_kernels.py:367)."""
    return int(round((1.0 - rate) * ((1 << 31) - 1)))


def dropout_keep_mask(seed, item, head, Tq: int, Tk: int, rate: float) -> torch.Tensor:
    """The host oracle of the in-kernel dropout draw: True = keep."""
    return keep_mask_tile(seed, item, head, Tq, Tk) < keep_threshold(rate)


def _train_keep(seed, B: int, H: int, T: int, rate: float, dev) -> torch.Tensor:
    """[B, H, T, T] keep factor: 1/(1-rate) where kept, 0 where dropped."""
    items = torch.arange(B, device=dev)[:, None]
    heads = torch.arange(H, device=dev)[None, :]
    keep = dropout_keep_mask(seed, items, heads, T, T, rate).to(dev)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, inv_keep.to(dev), torch.zeros((), device=dev))


def _train_scores(q_u, q_v, k, p, key_valid, H, scale):
    """The recomputed softmax weights of the train kernels (f32 [B, H, T, T])
    and the per-head operands, each rounded to the working dtype and held in
    f32: ``ac`` and ``bd`` round to the working dtype, their sum times the
    rounded scale rounds again, then the f32 key mask and softmax
    (attention_kernels.py:459-478)."""
    B, T, D = q_u.shape
    d = D // H
    wd = q_u.dtype
    heads = lambda x: x.reshape(x.shape[0], -1, H, d).transpose(1, 2).float()
    r = lambda x: x.to(wd).float()
    qu, qv, kh = heads(q_u), heads(q_v), heads(k)
    ph = p.reshape(1, 2 * T - 1, H, d).transpose(1, 2).float()[0]  # [H, 2T-1, d]
    ac = qu @ kh.transpose(-1, -2)
    bd_full = qv @ ph.transpose(-1, -2)  # [B, H, T, 2T-1]
    pos = torch.arange(T, device=q_u.device)
    idx = (T - 1) + pos[None, :] - pos[:, None]  # [T, T]: the espnet shift
    bd = bd_full.gather(-1, idx.expand(B, H, T, T))
    scale_w = torch.tensor(scale, dtype=wd).float().item()
    s = r(r(r(ac) + r(bd)) * scale_w)
    mask_add = torch.where(key_valid, 0.0, NEG_INF).float()
    w = torch.softmax(s + mask_add[:, None, None, :], dim=-1)
    return w, (qu, qv, kh, ph, idx)


def rel_attention_train_reference(q_u, q_v, k, v, p, key_valid, H, scale, rate, seed):
    """Plain version of the train forward (attention_kernels.py:371-403,
    480-498): rounds where the kernel rounds, in the inputs' dtype (exact
    f32 for f32 inputs); dropout multiplies the f32 weights by 1/(1-rate) or
    0 before they round for the product with v. Returns [B, T, D]."""
    B, T, D = q_u.shape
    w, _ = _train_scores(q_u, q_v, k, p, key_valid, H, scale)
    if rate > 0.0:
        w = w * _train_keep(seed, B, H, T, rate, q_u.device)
    vh = v.reshape(B, T, H, D // H).transpose(1, 2).float()
    out = w.to(q_u.dtype).float() @ vh
    return out.transpose(1, 2).reshape(B, T, D).to(q_u.dtype)


def rel_attention_train_backward_reference(
    q_u, q_v, k, v, p, key_valid, g, H, scale, rate, seed
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the train backward (attention_kernels.py:500-573):
    ``dv = w_used^T g``, ``dw = (g v^T) * keep``, ``ds = w (dw - sum(dw w))
    scale``, rounded to the working dtype; ``dq_u = ds k``, ``dk = ds^T
    q_u``, and ``dq_v``, ``dp`` from the skewed ``dbd[q, T-1+k-q] = ds[q, k]``
    (the adjoint of the relative shift), with ``dp`` summed over the batch in
    f32. Returns (dq_u, dq_v, dk, dv in the inputs' dtype, dp in p's)."""
    B, T, D = q_u.shape
    d = D // H
    wd = q_u.dtype
    heads = lambda x: x.reshape(B, T, H, d).transpose(1, 2).float()
    flat = lambda x: x.transpose(1, 2).reshape(B, -1, D).to(wd)
    w, (qu, qv, kh, ph, idx) = _train_scores(q_u, q_v, k, p, key_valid, H, scale)
    gh, vh = heads(g.to(wd)), heads(v)
    keepf = _train_keep(seed, B, H, T, rate, q_u.device) if rate > 0.0 else None
    w_used = w * keepf if keepf is not None else w
    dv = w_used.to(wd).float().transpose(-1, -2) @ gh
    dw = gh @ vh.transpose(-1, -2)
    if keepf is not None:
        dw = dw * keepf
    ds = w * (dw - (dw * w).sum(-1, keepdim=True)) * scale
    dsb = ds.to(wd).float()
    dqu = dsb @ kh
    dk = dsb.transpose(-1, -2) @ qu
    dbd = torch.zeros(B, H, T, 2 * T - 1, device=q_u.device)
    dbd.scatter_(-1, idx.expand(B, H, T, T), dsb)
    dqv = dbd @ ph
    dp = torch.einsum("bhqj,bhqd->jhd", dbd, qv).reshape(2 * T - 1, D)
    return flat(dqu), flat(dqv), flat(dk), flat(dv), dp.to(p.dtype)


@functools.lru_cache(maxsize=None)
def _train_lib() -> ctypes.CDLL:
    from espresso_tpu_torch.ops import cuda_build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = cuda_build.load("rel_attention_train", _TRAIN_SOURCES)
    # pointers, then B, T, H, scale, use_dropout, thresh, inv_keep, device, stream
    tail = [I, I, I, F, I, ctypes.c_uint32, F, I, P]
    lib.rel_attention_train_fwd_bf16.argtypes = [P] * 8 + tail
    lib.rel_attention_train_bwd_bf16.argtypes = [P] * 16 + tail
    lib.rel_attention_train_fwd_bf16.restype = I
    lib.rel_attention_train_bwd_bf16.restype = I
    return lib


def train_bwd_tmap_specs(B: int, T: int, D: int) -> list:
    """The tensor maps of the backward kernels, as {rank, dims (innermost
    first), strides (bytes), box} each: q_u, q_v, k, v and g as [D, T, B]
    read in boxes of one head (64 columns) x 64 positions x one utterance,
    so that a box never reaches into the next utterance and reads zeros
    past T; p as [D, 2T-1] in boxes of 64 x 64, zeros outside the table."""
    seq = [3, D, T, B, D * 2, T * D * 2, HEAD_DIM, 64, 1]
    return [seq] * 5 + [[2, D, 2 * T - 1, 0, D * 2, 0, HEAD_DIM, 64, 0]]


def _train_launch_args(q_u, seed, H, scale, rate):
    B, T, _ = q_u.shape
    if seed.device != q_u.device or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("rel_attention_train: seed must be one int32 on the inputs' card")
    device = q_u.device.index
    tail = (
        B, T, H, float(scale), int(rate > 0.0), keep_threshold(rate) if rate > 0.0 else 0,
        1.0 / (1.0 - rate), device, torch.cuda.current_stream(device).cuda_stream,
    )
    return tail


def rel_attention_train_fwd(q_u, q_v, k, v, p, key_valid, seed, H, scale, rate):
    """The train forward: [B, T, D] context with attention-weight dropout.
    ``seed`` is an int32 tensor of one element on the inputs' device. On
    the card: bf16 inputs, head width 64, T up to
    ``REL_ATTENTION_TRAIN_MAX_T`` (4096; past 1408 the long-row mode)."""
    if q_u.device.type == "cpu":
        return rel_attention_train_reference(q_u, q_v, k, v, p, key_valid, H, scale, rate, seed)
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_attention_train_fwd: unsupported device {q_u.device}")
    _check(q_u, q_v, k, v, p, key_valid, H, "rel_attention_train_fwd")
    T = q_u.shape[1]
    if T > REL_ATTENTION_TRAIN_MAX_T:
        raise ValueError(
            f"rel_attention_train_fwd: T={T} (the kernel takes T <= {REL_ATTENTION_TRAIN_MAX_T})"
        )
    tail = _train_launch_args(q_u, seed, H, scale, rate)
    out = torch.empty_like(q_u)
    rc = _train_lib().rel_attention_train_fwd_bf16(
        q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        key_valid.data_ptr(), seed.data_ptr(), out.data_ptr(), *tail,
    )
    if rc != 0:
        raise RuntimeError(f"rel_attention_train_fwd launch failed at T={q_u.shape[1]}: CUDA error {rc}")
    rel_attention_train_fwd.launches += 1
    return out


def dp_band_elements(B: int, T: int, D: int) -> int:
    """The backward's dp scratch, in f32 elements: a band of (nq + 1) * 64
    rows of D for each of the B * nq query blocks (nq = ceil(T / 64)), the
    dp rows T - 64 - 64 qt .. of query tile qt's windows."""
    nq = -(-T // HEAD_DIM)
    return B * nq * (nq + 1) * HEAD_DIM * D


def rel_attention_train_bwd(q_u, q_v, k, v, p, key_valid, seed, g, H, scale, rate):
    """The train backward: (dq_u, dq_v, dk, dv) [B, T, D] bf16 and dp
    [2T-1, D] f32 summed over the batch. On the card T up to
    ``REL_ATTENTION_TRAIN_MAX_T`` (4096), as the forward."""
    if q_u.device.type == "cpu":
        return rel_attention_train_backward_reference(
            q_u, q_v, k, v, p, key_valid, g, H, scale, rate, seed
        )
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_attention_train_bwd: unsupported device {q_u.device}")
    _check(q_u, q_v, k, v, p, key_valid, H, "rel_attention_train_bwd")
    if g.shape != q_u.shape or g.dtype != torch.bfloat16 or not g.is_contiguous():
        raise ValueError("rel_attention_train_bwd: g must be contiguous bf16 like q_u")
    B, T, D = q_u.shape
    if T > REL_ATTENTION_TRAIN_MAX_T:
        raise ValueError(
            f"rel_attention_train_bwd: T={T} (the kernels take T <= {REL_ATTENTION_TRAIN_MAX_T})"
        )
    tail = _train_launch_args(q_u, seed, H, scale, rate)
    dqu, dqv, dk, dv = (torch.empty_like(q_u) for _ in range(4))
    # the query pass stores each block's dp windows into its band (every
    # band row once), which a fixed-order sum adds into dp, and leaves each
    # row's softmax statistics (m, 1/l, sum dw w) for the key pass
    dp = torch.empty(2 * T - 1, D, dtype=torch.float32, device=q_u.device)
    bands = torch.empty(dp_band_elements(B, T, D), dtype=torch.float32, device=q_u.device)
    stats = torch.empty(3, B, H, T, dtype=torch.float32, device=q_u.device)
    specs = (ctypes.c_longlong * 54)(*sum(train_bwd_tmap_specs(B, T, D), []))
    rc = _train_lib().rel_attention_train_bwd_bf16(
        q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        key_valid.data_ptr(), seed.data_ptr(), g.data_ptr(), dqu.data_ptr(), dqv.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dp.data_ptr(), bands.data_ptr(), stats.data_ptr(),
        ctypes.addressof(specs),
        *tail,
    )
    if rc != 0:
        raise RuntimeError(f"rel_attention_train_bwd launch failed at T={T}: CUDA error {rc}")
    rel_attention_train_bwd.launches += 1
    return dqu, dqv, dk, dv, dp


rel_attention_train_fwd.launches = 0
rel_attention_train_bwd.launches = 0


class RelAttentionTrain(torch.autograd.Function):
    """Train-mode fused rel-pos self-attention: the forward kernel with
    in-kernel dropout, and the backward kernel for all five inputs."""

    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, key_valid, seed, H, scale, rate):
        ctx.save_for_backward(q_u, q_v, k, v, p, key_valid, seed)
        ctx.args = (H, scale, rate)
        return rel_attention_train_fwd(q_u, q_v, k, v, p, key_valid, seed, H, scale, rate)

    @staticmethod
    def backward(ctx, g):
        q_u, q_v, k, v, p, key_valid, seed = ctx.saved_tensors
        H, scale, rate = ctx.args
        dqu, dqv, dk, dv, dp = rel_attention_train_bwd(
            q_u, q_v, k, v, p, key_valid, seed, g.to(q_u.dtype).contiguous(), H, scale, rate
        )
        return (
            dqu.to(q_u.dtype), dqv.to(q_v.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dp.to(p.dtype), None, None, None, None, None,
        )


def rel_attention_train(q_u, q_v, k, v, p, key_valid, seed, H: int, scale: float, rate: float):
    """Fused rel-pos self-attention for training; returns [B, T, D] in the
    q_u dtype. ``seed``: an int32 tensor of one element on the inputs'
    device (its value picks the dropout mask; unused at rate 0)."""
    return RelAttentionTrain.apply(q_u, q_v, k, v, p, key_valid, seed, H, scale, rate)
