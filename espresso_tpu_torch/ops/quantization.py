"""Weight quantization: scalar int8, iPQ, quant noise and the w8a8 kernel.

Counterpart of ``espresso_tpu/ops/quantization.py``:

* ``quantize_int8`` / ``dequantize_int8`` (quantization.py:30-48) and the
  iPQ functions ``pq_*`` (:212-304): host numpy copies;
* ``quantize_params_int8`` / ``dequantize_params_int8`` (:51-93) and
  ``pq_quantize_params`` / ``pq_dequantize_params`` on a port model's
  parameters: the leaves JAX picks (flax ``kernel`` leaves, 2-D and of at
  least ``min_size`` elements for int8; of any rank for iPQ), named and laid
  out through ``bridge.flax_leaves``, quantized in the flax layout (int8
  along flax's output axis, axis 0 of a torch ``Linear.weight``), returned
  in the torch layout;
* quant noise (:96-133) as ``QuantNoise``, which the train step applies to
  its flat weights (``train/trainer.py``): every flax leaf that is 2-D with
  at least ``min_size`` elements (Dense kernels and the ``Embed`` table;
  convolution kernels are not) loses a fraction ``p`` of its blocks of
  ``block_size`` consecutive elements of the flax row-major layout, the
  rest scaled by ``1 / (1 - p)``;
* ``int8_matmul`` (:141-199), the w8a8 TPU kernel, hand-written CUDA C++
  for ``sm_90a`` in ``csrc/int8_matmul.cu``, with ``int8_matmul_plain``
  beside it. On a CPU tensor the wrapper runs the plain version; on a CUDA
  tensor it launches the kernel or raises, at any M, K and N, and counts its
  launches (``int8_matmul.launches``). Neither package calls it on a model
  path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from espresso_tpu_torch.bridge import flax_leaves, from_flax_layout, to_flax_layout

LIBRARIES = {"int8_matmul": ("int8_matmul.cu", "hopper_sm90.cuh")}

# ---------------------------------------------------------------------------
# scalar int8 (host)
# ---------------------------------------------------------------------------


def quantize_int8(w: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along ``axis``. Returns
    (int8 values, fp32 scales)."""
    w = np.asarray(w, np.float32)
    axis = axis % w.ndim
    amax = np.max(np.abs(w), axis=tuple(i for i in range(w.ndim) if i != axis))
    scale = np.maximum(amax, 1e-8) / 127.0
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8(q: np.ndarray, scale: np.ndarray, axis: int = -1) -> np.ndarray:
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    return q.astype(np.float32) * scale.reshape(shape)


def _host(p: torch.Tensor) -> np.ndarray:
    return p.detach().float().cpu().numpy()


def quantize_params_int8(
    model: nn.Module, min_size: int = 4096
) -> Tuple[Dict[str, Any], int, int]:
    """Quantize every parameter whose flax leaf is a 2-D ``kernel`` of at
    least ``min_size`` elements, per output channel. Returns (parameter
    name -> host array, or ``{"__int8__": True, "q": int8 [out, in],
    "scale": [out]}``; n_quantized; n_parameters)."""
    out, n_q = {}, 0
    leaves = flax_leaves(model)
    for name, p in model.named_parameters():
        if leaves[name] == "kernel" and p.dim() == 2 and p.numel() >= min_size:
            # flax [in, out] along its last axis == torch [out, in] along axis 0
            q, s = quantize_int8(_host(p), axis=0)
            out[name] = {"__int8__": True, "q": q, "scale": s}
            n_q += 1
        else:
            out[name] = _host(p)
    return out, n_q, len(out)


def dequantize_params_int8(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params_int8`: name -> f32 tensor, ready for
    ``model.load_state_dict(..., strict=False)``."""
    return {
        k: torch.from_numpy(
            dequantize_int8(v["q"], v["scale"], axis=0) if isinstance(v, dict) else v
        )
        for k, v in params.items()
    }


# ---------------------------------------------------------------------------
# product quantization (iPQ, host)
# ---------------------------------------------------------------------------


def pq_quantize(
    w: np.ndarray, block_size: int = 8, n_centroids: int = 256, iters: int = 15, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """k-means codebook over [block_size] sub-vectors of a weight's row-major
    elements. Returns (centroids [n_centroids, block_size], codes)."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(-1)
    pad = (-flat.size) % block_size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    vecs = flat.reshape(-1, block_size)
    rng = np.random.default_rng(seed)
    k = min(n_centroids, len(vecs))
    centroids = vecs[rng.choice(len(vecs), size=k, replace=False)].copy()
    for _ in range(iters):
        codes = np.empty(len(vecs), np.int64)
        for s in range(0, len(vecs), 65536):  # chunked to bound memory
            chunk = vecs[s : s + 65536]
            d = ((chunk[:, None, :] - centroids[None]) ** 2).sum(-1)
            codes[s : s + len(chunk)] = d.argmin(1)
        for c in range(k):
            sel = codes == c
            if sel.any():
                centroids[c] = vecs[sel].mean(0)
    dtype = np.uint8 if k <= 256 else np.uint16
    return centroids, codes.astype(dtype)


def pq_dequantize(centroids: np.ndarray, codes: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    flat = centroids[codes.astype(np.int64)].reshape(-1)
    return flat[: int(np.prod(shape))].reshape(shape).astype(np.float32)


def pq_quantize_params(
    model: nn.Module, block_size: int = 8, n_centroids: int = 256, min_size: int = 4096,
) -> Dict[str, Any]:
    """PQ-compress every parameter whose flax leaf is a ``kernel`` of at
    least ``min_size`` elements, over the sub-vectors of the flax layout.
    Inverse: :func:`pq_dequantize_params`."""
    leaves = flax_leaves(model)
    out = {}
    for name, p in model.named_parameters():
        if leaves[name] == "kernel" and p.numel() >= min_size:
            w = to_flax_layout("kernel", _host(p))
            cent, codes = pq_quantize(w, block_size, n_centroids)
            out[name] = {"__pq__": True, "centroids": cent, "codes": codes,
                         "shape": np.asarray(w.shape, np.int64)}
        else:
            out[name] = _host(p)
    return out


def pq_dequantize_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            w = pq_dequantize(v["centroids"], v["codes"], tuple(int(s) for s in v["shape"]))
            v = np.ascontiguousarray(from_flax_layout("kernel", w))
        out[k] = torch.from_numpy(v)
    return out


# ---------------------------------------------------------------------------
# quant noise
# ---------------------------------------------------------------------------


class QuantNoise:
    """Quant noise on a model's flat weights (the train state's buffers,
    in ``model.parameters()`` order).

    ``block_of`` maps each element to its block: the noised leaves' blocks
    are numbered leaf after leaf in the flax layout, and every element of
    another leaf points at one extra block that is always kept. A draw is
    one ``keep`` bit per block; ``apply`` gives ``where(keep, w / (1 - p), 0)``
    on the noised leaves and ``w`` elsewhere. The gradient with respect to
    the noised weights reaches the masters through ``apply`` too."""

    def __init__(self, model: nn.Module, p: float, block_size: int = 8, min_size: int = 4096):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quant noise p={p} must lie in (0, 1)")
        self.p, self.block_size = p, block_size
        leaves = flax_leaves(model)
        params = list(model.named_parameters())
        dev = params[0][1].device
        # (name, flat offset, numel, first block, flax leaf name, flax shape)
        self.leaves = []
        off = nb = 0
        for name, w in params:
            n = w.numel()
            flax_shape = tuple(to_flax_layout(leaves[name], w.detach()).shape)
            if len(flax_shape) == 2 and n >= min_size:
                self.leaves.append((name, off, n, nb, leaves[name], flax_shape))
                nb += -(-n // block_size)
            off += n
        self.n_blocks, self.numel = nb, off
        block_of = torch.full((off,), nb, dtype=torch.int32)
        for _, o, n, first, leaf, flax_shape in self.leaves:
            idx = (torch.arange(n, dtype=torch.int32) // block_size + first).view(flax_shape)
            block_of[o : o + n] = from_flax_layout(leaf, idx).reshape(-1)
        self.block_of = block_of.to(dev)
        self.noised = self.block_of < nb
        # a tensor divisor: a CUDA division by a host scalar multiplies by
        # its reciprocal instead
        self._keep_rate = torch.tensor(1.0 - p, dtype=torch.float32, device=dev)

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """One keep bit per noised block, kept with probability 1 - p (as
        ``jax.random.bernoulli(key, 1 - p)``), drawn on the device."""
        u = torch.rand(self.n_blocks, generator=generator, device=self.block_of.device)
        return u < 1.0 - self.p

    def mask(self, keep_blocks: torch.Tensor) -> torch.Tensor:
        """Per-element keep mask [numel] from the per-block draw."""
        ext = torch.cat([keep_blocks, keep_blocks.new_ones(1)])
        return ext[self.block_of]

    def apply(self, flat: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """The noised weights, or the masters' gradient from the noised
        weights' one (d/dw of w / (1 - p) is 1 / (1 - p))."""
        scaled = torch.where(self.noised, flat / self._keep_rate, flat)
        return torch.where(keep, scaled, torch.zeros((), dtype=flat.dtype, device=flat.device))


# ---------------------------------------------------------------------------
# w8a8 matmul (Hopper kernel)
# ---------------------------------------------------------------------------


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: the same arithmetic, the int8
    product summed exactly in float64 (|sum| < 2^53). The scale is
    ``max(amax, 1e-8)`` times the f32 reciprocal of 127, as XLA computes the
    JAX kernel's ``/ 127.0``; the quantization divides by it."""
    xt = x.float()
    amax = xt.abs().amax(1) if xt.shape[1] else xt.new_zeros(xt.shape[0])
    xs = torch.clamp(amax, min=1e-8) * amax.new_full((), 1.0 / 127.0)
    xq = torch.clamp(torch.round(xt / xs[:, None]), -127, 127)
    acc = xq.double() @ w_q.double()
    return acc.float() * xs[:, None] * w_scale.float()[None, :]


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from espresso_tpu_torch.ops import cuda_build

    lib = cuda_build.load("int8_matmul", LIBRARIES["int8_matmul"])
    # x, x_bf16, x_vec, w, w_scale, xq, xs, out; M, N, K, Kp, Kw, ldb, device; stream
    lib.int8_matmul_f32.argtypes = [_P, _I, _I] + [_P] * 5 + [_I] * 7 + [_P]
    lib.int8_matmul_f32.restype = _I
    return lib


K_TILE = 128  # the product's k-tile: one 128-byte TMA box of int8


def int8_w_route(w_q: torch.Tensor) -> str:
    """How the kernel reads ``w_q`` (the transposed view of an [N, K] int8
    tensor): "direct" by TMA where its rows start on 16 bytes, else
    "padded", from a zero-padded [N, Kp] copy the wrapper makes."""
    K, N = w_q.shape
    ldb = w_q.stride(1) if N > 1 else K
    return "direct" if ldb % 16 == 0 and w_q.data_ptr() % 16 == 0 else "padded"


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """w8a8 matmul: x [M, K] f32 or bf16, w_q [K, N] int8, w_scale [N] f32
    -> [M, N] f32. On the card ``w_q`` is the transposed view of a [N, K]
    tensor whose rows are contiguous (an int8 ``nn.Linear`` weight, as
    :func:`quantize_params_int8` gives it: ``torch.from_numpy(q).t()``);
    any M, K and N: rows of w not on 16 bytes are read from a zero-padded
    copy (:func:`int8_w_route`), and an N whose f32 rows are not a multiple
    of 16 bytes is written by predicated stores instead of TMA stores."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and w_q {tuple(w_q.shape)} "
                         "must be [M, K] and [K, N]")
    M, K = x.shape
    N = w_q.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: x must be f32 or bf16, not {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.device != x.device or w_q.stride(0) != 1:
        raise ValueError("int8_matmul: w_q must be int8 on the same card, the transposed "
                         "view of an [N, K] tensor with contiguous rows")
    if w_scale.shape != (N,) or w_scale.dtype != torch.float32 or w_scale.device != x.device:
        raise ValueError(f"int8_matmul: w_scale must be [{N}] f32 on {x.device}")
    x = x.contiguous()
    w_scale = w_scale.contiguous()
    Kp = max(-(-K // K_TILE) * K_TILE, K_TILE)
    if int8_w_route(w_q) == "direct":
        w, Kw, ldb = w_q, K, (w_q.stride(1) if N > 1 else K)
    else:
        w = torch.zeros(N, Kp, dtype=torch.int8, device=x.device)
        w[:, :K] = w_q.t()
        Kw, ldb = Kp, Kp
    x_vec = int(x.data_ptr() % 16 == 0 and K % (16 // x.element_size()) == 0)
    xq = torch.empty(M, Kp, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    device = x.device.index
    rc = _lib().int8_matmul_f32(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x_vec, w.data_ptr(), w_scale.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), out.data_ptr(), M, N, K, Kp, Kw, ldb, device,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
