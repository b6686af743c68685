"""Lattice-free RNNT loss through the joint kernels (Hopper).

Counterpart of ``espresso_tpu/ops/rnnt_pallas.py``. Two TPU kernels are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``:

* ``rnnt_joint_lp`` (``csrc/rnnt_joint_lp.cu``, the Pallas ``rnnt_joint_lp``,
  rnnt_pallas.py:83-208): per (b, t, u) row, ``pre = relu(enc_proj[t] +
  dec_proj[u])`` rounded to the compute dtype, the logits ``pre @ W + b``
  summed in f32 and streamed over V with an online logsumexp; returns the
  blank and target-column log-probs and the logsumexp, each [B, T, U1] f32.
* ``rnnt_joint_bwd`` (``csrc/rnnt_joint_bwd.cu``, rnnt_pallas.py:211-393):
  recomputes the logits, forms ``glog = -softmax * (ob + ol)`` plus ``ob`` at
  the blank column and ``ol`` at the target column, and contracts it into
  ``g_enc`` [B, T, J], ``g_dec`` [B, U1, J], ``g_W`` [J, V] and ``g_b`` [V],
  all f32. Its blocks store partial sums into slots of a workspace, which a
  third kernel sums in a fixed order: two launches on the same inputs are
  bit-equal.

The [B, T, U1, V] lattice is never written by either kernel. Both take any
V (the ragged tail of the last V tile is masked). The loss built from them
is ``ops/rnnt_fused.py::RnntLossFused``.

Layouts: ``fc_kernel`` is [J, V] as in JAX; the kernels read it as the
``nn.Linear`` weight [V, J], so on the card it must be the transposed view
of a contiguous [V, J] tensor (``fc_out.weight.t()``). On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises, and counts its launches (``fn.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from espresso_tpu_torch.ops.rnnt import NEG_INF

# library name -> its CUDA sources (with the headers they include)
LIBRARIES = {
    "rnnt_joint_lp": ("rnnt_joint_lp.cu", "rnnt_joint_common.cuh", "hopper_sm90.cuh"),
    "rnnt_joint_bwd": ("rnnt_joint_bwd.cu", "rnnt_joint_common.cuh", "hopper_sm90.cuh"),
}
# joint widths the kernels take: they stage [rows, J] bf16 tiles in shared
# memory, and the backward keeps J-wide register tiles (a template per width)
JOINT_WIDTHS = (128, 256, 512)
_FRAME_CHUNK = 16  # frames per step of the plain versions (bounds their memory)
# rnnt_joint_bwd's tiles: 8 values of u x 8 frames of one utterance (64
# lattice rows), and 64 vocab columns per W tile
TILE_U, TILE_T, TILE_V = 8, 8, 64


def _targets_u1(targets: torch.Tensor, U1: int) -> torch.Tensor:
    """[B, U] targets -> [B, U1] with a 0 column at u = U1-1 (rnnt_pallas.py
    :76-79): the last row has no label."""
    B = targets.shape[0]
    zero = torch.zeros(B, 1, dtype=targets.dtype, device=targets.device)
    return torch.cat([targets[:, : U1 - 1], zero], 1)


def _pre(enc_proj, dec_proj, t0, t1):
    """relu(enc + dec) in f32 for frames [t0, t1): [B, C, U1, J]."""
    return torch.relu(enc_proj[:, t0:t1, None, :].float() + dec_proj[:, None, :, :].float())


def _logits(pre_c, fc_kernel, fc_bias):
    """f32 logits of the rounded joint hidden: [..., J] -> [..., V]."""
    return pre_c.float() @ fc_kernel.float() + fc_bias.float()


def rnnt_joint_lp_reference(enc_proj, dec_proj, fc_kernel, fc_bias, targets, blank):
    """Plain version of :func:`rnnt_joint_lp`: (lp_blank, lp_label, lse), each
    [B, T, U1] f32, lp_label NEG_INF at u = U1-1."""
    B, T, _ = enc_proj.shape
    U1 = dec_proj.shape[1]
    tgt = _targets_u1(targets, U1).long()
    lpb, lpl, lse = [], [], []
    for t0 in range(0, T, _FRAME_CHUNK):
        t1 = min(T, t0 + _FRAME_CHUNK)
        logits = _logits(_pre(enc_proj, dec_proj, t0, t1).to(enc_proj.dtype), fc_kernel, fc_bias)
        z = torch.logsumexp(logits, -1)
        lse.append(z)
        lpb.append(logits[..., blank] - z)
        idx = tgt[:, None, :, None].expand(B, t1 - t0, U1, 1)
        lpl.append(logits.gather(-1, idx)[..., 0] - z)
    lp_label = torch.cat(lpl, 1)
    u_idx = torch.arange(U1, device=enc_proj.device)
    lp_label = torch.where(u_idx < U1 - 1, lp_label, torch.full_like(lp_label, NEG_INF))
    return torch.cat(lpb, 1), lp_label, torch.cat(lse, 1)


def rnnt_joint_bwd_reference(
    enc_proj, dec_proj, fc_kernel, fc_bias, targets, lse, occb_n, occl_n, blank
):
    """Plain version of :func:`rnnt_joint_bwd`: (g_enc [B, T, J], g_dec
    [B, U1, J], g_W [J, V], g_b [V]), all f32. ``glog`` is summed into
    ``g_b`` in f32 and rounds to the compute dtype before the two products
    (rnnt_pallas.py:311-332); ``g_pre`` is masked by ``pre > 0``."""
    B, T, J = enc_proj.shape
    U1 = dec_proj.shape[1]
    V = fc_kernel.shape[1]
    cdt = enc_proj.dtype
    tgt = _targets_u1(targets, U1).long()
    W = fc_kernel.float()
    g_enc = torch.zeros(B, T, J, device=enc_proj.device)
    g_dec = torch.zeros(B, U1, J, device=enc_proj.device)
    g_W = torch.zeros(J, V, device=enc_proj.device)
    g_b = torch.zeros(V, device=enc_proj.device)
    for t0 in range(0, T, _FRAME_CHUNK):
        t1 = min(T, t0 + _FRAME_CHUNK)
        pre_f = _pre(enc_proj, dec_proj, t0, t1)
        pre = pre_f.to(cdt).float()
        p = torch.exp(_logits(pre, fc_kernel, fc_bias) - lse[:, t0:t1, :, None])
        ob, ol = occb_n[:, t0:t1].float(), occl_n[:, t0:t1].float()
        glog = -p * (ob + ol)[..., None]
        glog[..., blank] += ob
        idx = tgt[:, None, :, None].expand(B, t1 - t0, U1, 1)
        glog.scatter_add_(-1, idx, ol[..., None])
        g_b += glog.sum((0, 1, 2))
        glog_c = glog.to(cdt).float()
        g_W += pre.reshape(-1, J).t() @ glog_c.reshape(-1, V)
        g_pre = torch.where(pre_f > 0, glog_c @ W.t(), torch.zeros((), device=p.device))
        g_enc[:, t0:t1] = g_pre.sum(2)
        g_dec += g_pre.sum(1)
    return g_enc, g_dec, g_W, g_b


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    from espresso_tpu_torch.ops import cuda_build

    lib = cuda_build.load(name, LIBRARIES[name])
    fn = getattr(lib, name + "_bf16")
    if name == "rnnt_joint_lp":
        fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]  # B, T, U1, J, V, blank, device, stream
    else:  # 13 tensors (the workspace last), the tensor map, B, T, U1, J, V, blank, the schedule, device, stream
        fn.argtypes = [_P] * 14 + [_I] * 13 + [_P]
    fn.restype = _I
    return lib


def _block_share(n: int, grid: int, k: int) -> range:
    """The work items of block k of ``grid``: [n k / grid, n (k + 1) / grid)."""
    return range(n * k // grid, n * (k + 1) // grid)


def _slots(n: int, grid: int, group: int) -> int:
    """The most groups of ``group`` consecutive work items that one block's
    share meets (its slots in the workspace)."""
    return max((sh[-1] // group) - (sh[0] // group) + 1
               for sh in (_block_share(n, grid, k) for k in range(grid)))


def joint_bwd_schedule(B: int, T: int, U1: int, V: int, n_sm: int) -> dict:
    """The work split of ``rnnt_joint_bwd``'s kernels: tiles of 8 values
    of u x 8 frames of one utterance, tile i = (b * nu + ug) * nt + ts; the
    rows kernel's blocks take contiguous shares of the tiles, the columns
    kernel's of the (V tile, tile) units, V tile slowest; a block per SM.
    ``runs_max``: the most runs (the nt tiles of one (b, u group)) a rows
    block meets; ``segs_max``: the most V tiles a columns block meets."""
    nu, nt = -(-U1 // TILE_U), -(-T // TILE_T)
    tiles = B * nu * nt
    units = tiles * -(-V // TILE_V)
    grid_rows, grid_cols = min(tiles, n_sm), min(units, n_sm)
    return dict(nu=nu, nt=nt, tiles=tiles, units=units, grid_rows=grid_rows,
                grid_cols=grid_cols, runs_max=_slots(tiles, grid_rows, nt),
                segs_max=_slots(units, grid_cols, tiles))


def joint_bwd_workspace(sched: dict, J: int) -> dict:
    """The f32 elements of ``rnnt_joint_bwd``'s slots (csrc/rnnt_joint_bwd.cu):
    ws_enc [tiles, 8, J], ws_dec [grid_rows, runs_max, 8, J], ws_w
    [grid_cols, segs_max, 64, J], ws_b [grid_cols, segs_max, 64], in that
    order in one buffer."""
    return dict(
        enc=sched["tiles"] * TILE_T * J,
        dec=sched["grid_rows"] * sched["runs_max"] * TILE_U * J,
        w=sched["grid_cols"] * sched["segs_max"] * TILE_V * J,
        b=sched["grid_cols"] * sched["segs_max"] * TILE_V,
    )


def joint_bwd_tmap_spec(J: int, V: int) -> list:
    """The tensor map of the output weights, the [V, J] bf16 rows of the
    nn.Linear layout, as {rank, dims (innermost first), strides (bytes),
    box}: boxes of 64 columns x 64 vocab rows, zeros past V."""
    return [2, J, V, 0, J * 2, 0, 64, TILE_V, 0]


def _check(name, enc_proj, dec_proj, fc_kernel, fc_bias, targets):
    B, T, J = enc_proj.shape
    U1 = dec_proj.shape[1]
    V = fc_kernel.shape[1]
    dev = enc_proj.device
    for arg, x in (("enc_proj", enc_proj), ("dec_proj", dec_proj), ("fc_kernel", fc_kernel)):
        if x.device != dev or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bf16 on {dev}")
    if not (enc_proj.is_contiguous() and dec_proj.is_contiguous()):
        raise ValueError(f"{name}: enc_proj and dec_proj must be contiguous")
    if not fc_kernel.t().is_contiguous():
        raise ValueError(f"{name}: fc_kernel must be the transposed view of a [V, J] weight")
    if dec_proj.shape != (B, U1, J) or fc_kernel.shape[0] != J or fc_bias.shape != (V,):
        raise ValueError(f"{name}: shapes {tuple(dec_proj.shape)}, {tuple(fc_kernel.shape)}, "
                         f"{tuple(fc_bias.shape)} do not fit enc_proj {(B, T, J)}")
    if J not in JOINT_WIDTHS:
        raise ValueError(f"{name}: joint width {J} (the kernels take {JOINT_WIDTHS})")
    if fc_bias.device != dev or targets.device != dev or targets.shape != (B, U1 - 1):
        raise ValueError(f"{name}: fc_bias and targets [B, U1-1] must be on {dev}")


def _launch_tail(enc_proj, dec_proj, fc_kernel, blank):
    B, T, J = enc_proj.shape
    device = enc_proj.device.index
    return (B, T, dec_proj.shape[1], J, fc_kernel.shape[1], blank, device,
            torch.cuda.current_stream(device).cuda_stream)


def rnnt_joint_lp(enc_proj, dec_proj, fc_kernel, fc_bias, targets, blank: int):
    """(lp_blank, lp_label, lse), each [B, T, U1] f32, from enc_proj
    [B, T, J], dec_proj [B, U1, J], fc_kernel [J, V], fc_bias [V] and
    targets [B, U1-1]; lp_label is NEG_INF at u = U1-1."""
    if enc_proj.device.type == "cpu":
        return rnnt_joint_lp_reference(enc_proj, dec_proj, fc_kernel, fc_bias, targets, blank)
    if enc_proj.device.type != "cuda":
        raise ValueError(f"rnnt_joint_lp: unsupported device {enc_proj.device}")
    _check("rnnt_joint_lp", enc_proj, dec_proj, fc_kernel, fc_bias, targets)
    B, T, _ = enc_proj.shape
    U1 = dec_proj.shape[1]
    tgt = _targets_u1(targets, U1).to(torch.int32)
    bias = fc_bias.float()
    lpb, lpl, lse = (
        torch.empty(B, T, U1, dtype=torch.float32, device=enc_proj.device) for _ in range(3)
    )
    rc = _lib("rnnt_joint_lp").rnnt_joint_lp_bf16(
        enc_proj.data_ptr(), dec_proj.data_ptr(), fc_kernel.data_ptr(),
        bias.data_ptr(), tgt.data_ptr(), lpb.data_ptr(), lpl.data_ptr(),
        lse.data_ptr(), *_launch_tail(enc_proj, dec_proj, fc_kernel, blank),
    )
    if rc != 0:
        raise RuntimeError(f"rnnt_joint_lp launch failed: CUDA error {rc}")
    rnnt_joint_lp.launches += 1
    return lpb, lpl, lse


def rnnt_joint_bwd(enc_proj, dec_proj, fc_kernel, fc_bias, targets, lse, occb_n, occl_n, blank: int):
    """(g_enc [B, T, J], g_dec [B, U1, J], g_W [J, V], g_b [V]), all f32,
    from the inputs of :func:`rnnt_joint_lp`, its ``lse`` and the
    occupancy-weighted upstream gradients occb_n, occl_n [B, T, U1] f32."""
    if enc_proj.device.type == "cpu":
        return rnnt_joint_bwd_reference(
            enc_proj, dec_proj, fc_kernel, fc_bias, targets, lse, occb_n, occl_n, blank
        )
    if enc_proj.device.type != "cuda":
        raise ValueError(f"rnnt_joint_bwd: unsupported device {enc_proj.device}")
    _check("rnnt_joint_bwd", enc_proj, dec_proj, fc_kernel, fc_bias, targets)
    B, T, J = enc_proj.shape
    U1 = dec_proj.shape[1]
    V = fc_kernel.shape[1]
    for arg, x in (("lse", lse), ("occb_n", occb_n), ("occl_n", occl_n)):
        if x.shape != (B, T, U1) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"rnnt_joint_bwd: {arg} must be contiguous [B, T, U1] f32")
    tgt = _targets_u1(targets, U1).to(torch.int32)
    dev = enc_proj.device
    # the sum kernel writes every element of these from the slots in `ws`
    g_enc = torch.empty(B, T, J, device=dev)
    g_dec = torch.empty(B, U1, J, device=dev)
    g_Wt = torch.empty(V, J, device=dev)
    g_b = torch.empty(V, device=dev)
    bias = fc_bias.float()
    sched = joint_bwd_schedule(B, T, U1, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = torch.empty(sum(joint_bwd_workspace(sched, J).values()), device=dev)
    spec = (ctypes.c_longlong * 9)(*joint_bwd_tmap_spec(J, V))
    rc = _lib("rnnt_joint_bwd").rnnt_joint_bwd_bf16(
        enc_proj.data_ptr(), dec_proj.data_ptr(), fc_kernel.data_ptr(),
        bias.data_ptr(), tgt.data_ptr(), lse.data_ptr(), occb_n.data_ptr(),
        occl_n.data_ptr(), g_enc.data_ptr(), g_dec.data_ptr(), g_Wt.data_ptr(),
        g_b.data_ptr(), ws.data_ptr(), ctypes.addressof(spec), B, T, U1, J, V, blank, sched["nu"],
        sched["nt"], sched["grid_rows"], sched["grid_cols"], sched["runs_max"], sched["segs_max"],
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rnnt_joint_bwd launch failed: CUDA error {rc}")
    rnnt_joint_bwd.launches += 1
    return g_enc, g_dec, g_Wt.t(), g_b


rnnt_joint_lp.launches = 0
rnnt_joint_bwd.launches = 0
