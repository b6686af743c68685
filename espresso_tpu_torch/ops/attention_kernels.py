"""Fused relative-position self-attention for inference (Hopper kernel).

Counterpart of ``espresso_tpu/ops/attention_kernels.py``: ``rel_attention``
wraps the hand-written CUDA kernel ``csrc/rel_attention.cu`` (which replaces
the Pallas ``rel_attention_fused``), and ``rel_attention_reference`` is its
plain PyTorch version (attention_kernels.py:106-128). Both take the
flattened-heads layout of the JAX call site: ``q_u, q_v, k, v`` [B, T, D],
``p`` [2T-1, D], ``key_valid`` [B, T] bool, and return [B, T, D].

On a CPU tensor ``rel_attention`` runs the plain version; on a CUDA tensor it
launches the kernel or raises. The training kernels (dropout forward and
flash-style backward) wait for the train slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from espresso_tpu_torch.ops.masking import NEG_INF

HEAD_DIM = 64  # the kernel's only head width (the flagship's d = 512 / 8)
_SOURCES = ("rel_attention.cu",)


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


def build() -> str:
    """Compile (or load the cached) kernel library for sm_90a; returns the
    nvcc log of the build (registers, shared memory and spills)."""
    from espresso_tpu_torch.ops import cuda_build

    _lib()
    return cuda_build.build_log("rel_attention", _SOURCES)


def _check(q_u, q_v, k, v, p, key_valid, H):
    B, T, D = q_u.shape
    dev = q_u.device
    for name, x in (("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v), ("p", p)):
        if x.device != dev or x.dtype != torch.bfloat16:
            raise ValueError(f"rel_attention: {name} must be bf16 on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"rel_attention: {name} must be contiguous and aligned")
    for name, x in (("q_v", q_v), ("k", k), ("v", v)):
        if x.shape != (B, T, D):
            raise ValueError(f"rel_attention: {name} {tuple(x.shape)} != {(B, T, D)}")
    if p.shape != (2 * T - 1, D):
        raise ValueError(f"rel_attention: p {tuple(p.shape)} != {(2 * T - 1, D)}")
    if D != H * HEAD_DIM:
        raise ValueError(f"rel_attention: head dim {D // H} (kernel takes {HEAD_DIM})")
    if (
        key_valid.device != dev
        or key_valid.dtype != torch.bool
        or key_valid.shape != (B, T)
        or not key_valid.is_contiguous()
    ):
        raise ValueError("rel_attention: key_valid must be contiguous [B, T] bool")


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
    the output projection). ``rel_attention.launches`` counts kernel
    launches."""
    if q_u.device.type == "cpu":
        return rel_attention_reference(q_u, q_v, k, v, p, key_valid, H, scale)
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {q_u.device}")
    _check(q_u, q_v, k, v, p, key_valid, H)
    B, T, D = q_u.shape
    out = torch.empty_like(q_u)
    device = q_u.device.index  # a CUDA tensor's device always has its index
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _lib().rel_attention_bf16(
        q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        key_valid.data_ptr(), out.data_ptr(), B, T, H, float(scale), device, stream,
    )
    if rc != 0:
        # e.g. cudaErrorInvalidValue when T needs more shared memory than a
        # block may have (the score rows grow with T)
        raise RuntimeError(f"rel_attention kernel launch failed at T={T}: CUDA error {rc}")
    rel_attention.launches += 1
    return out


rel_attention.launches = 0
