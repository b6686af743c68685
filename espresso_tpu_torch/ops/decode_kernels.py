"""AES beam-search decode kernels (Hopper) and their plain versions.

Counterpart of ``espresso_tpu/ops/decode_kernels.py``. Four TPU kernels of
the AES frame step are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``:

* ``fused_joint_topk`` (``csrc/fused_joint_topk.cu``): the joint, its
  log-softmax, the blank log-prob and each row's exact top-n label
  candidates of ``score + lp``;
* ``lstm_step_reorder`` (``csrc/lstm_step_reorder.cu``): beam reorder +
  L-layer LSTM step + live mask on the packed prediction-net state;
* ``aes_merge`` (``csrc/aes_merge.cu``): one blank-merge round;
* ``aes_backtrace`` (``csrc/aes_backtrace.cu``): the reverse walk of the
  merge and expansion backpointers.

The first two run their products on ``wgmma`` from weight tiles that TMA
brings into mbarrier-guarded rings (``csrc/hopper_sm90.cuh``); the weights'
layout and tensor maps are made once per weight set.

Each wrapper runs its plain PyTorch version (``*_reference``) for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises, and counts
its launches (``fn.launches``). The plain versions take the wrappers'
arguments, so a caller can route to them on the card for a comparison.

Not ported: the JAX shape gates (``supports_fused_joint_topk``,
``supports_lstm_step_reorder``), the ``V % 128`` test, the VMEM budget and
``ESPRESSO_LSTM_KERNEL_F32``. ``prep_lstm_kernel_inputs`` gate-pads a cell
stack (an LSTM LM, a prediction net whose embedding width is not its hidden
width) to the kernel's multiple of 64. The fused
joint always returns per-row candidates (the JAX ``row_level=True`` form);
``rows_topk`` finishes the per-utterance selection.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Optional, Sequence, Tuple

import torch

from espresso_tpu_torch.modules.lstm import lstm_gates

NEG_INF = -1.0e9
LN_EPS = 1e-6  # the joint's ln_dec epsilon, as the TPU kernel hard-codes it
MAX_CAND = 32  # the joint kernel keeps per-thread top lists of 16 or 32

# library name -> its CUDA source under csrc/ (with the headers it includes)
LIBRARIES = {
    "fused_joint_topk": ("fused_joint_topk.cu", "hopper_sm90.cuh"),
    "lstm_step_reorder": ("lstm_step_reorder.cu", "hopper_sm90.cuh"),
    "aes_merge": ("aes_merge.cu",),
    "aes_backtrace": ("aes_backtrace.cu", "hopper_sm90.cuh"),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> (library, argument types); a launching entry ends in (device, stream)
_SIGNATURES = {
    "fused_joint_topk_bf16": ("fused_joint_topk", [_P, _P, _I] + [_P] * 12 + [_I] * 9 + [_P]),
    "fused_joint_topk_tmaps": ("fused_joint_topk", [_P, _P, _I, _I, _I, _P]),
    "lstm_step_reorder_bf16": ("lstm_step_reorder", [_P] * 8 + [_I] * 4 + [_P]),
    "lstm_step_reorder_tmap": ("lstm_step_reorder", [_P, _I, _I, _P]),
    "aes_merge_f32": ("aes_merge", [_P] * 7 + [_I] * 3 + [_P] * 2 + [_I, _P]),
    "aes_backtrace_i32": ("aes_backtrace", [_P] * 8 + [_I] * 5 + [_P]),
}
TMAP_BYTES = 128  # a CUtensorMap


# ---------------------------------------------------------------------------
# packed LSTM state and the cross-row top-k
# ---------------------------------------------------------------------------


def pack_lstm_state(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[L, BK, H] h/c -> packed [BK, 2LH] column blocks [h_0..h_{L-1} |
    c_0..c_{L-1}] (decode_kernels.py:455-467)."""
    L, BK, H = h.shape
    return torch.cat(
        [h.permute(1, 0, 2).reshape(BK, L * H), c.permute(1, 0, 2).reshape(BK, L * H)], 1
    )


def unpack_lstm_state(S: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_lstm_state`."""
    BK, C = S.shape
    H = C // (2 * L)
    h = S[:, : L * H].reshape(BK, L, H).permute(1, 0, 2)
    c = S[:, L * H :].reshape(BK, L, H).permute(1, 0, 2)
    return h, c


def lstm_feat(S: torch.Tensor, L: int) -> torch.Tensor:
    """Top-layer hidden slice of the packed state (the pred-net feature): a
    strided view, row stride 2LH."""
    H = S.shape[1] // (2 * L)
    return S[:, (L - 1) * H : L * H]


LSTM_KERNEL_MULTIPLE = 64  # lstm_step_reorder's hidden widths


def prep_lstm_kernel_inputs(
    embed: torch.Tensor,
    w_ih: Sequence[torch.Tensor],
    b_ih: Sequence[torch.Tensor],
    w_hh: Sequence[torch.Tensor],
) -> dict:
    """A cell stack in the form :func:`lstm_step_reorder` takes
    (decode_kernels.py:648-718): ``embed`` [V, E], the input kernels
    ``w_ih`` [E or H, 4H] (``x @ w``), biases ``b_ih`` [4H] and recurrent
    kernels ``w_hh`` [H, 4H], one per layer, gate order i, f, g, o. Returns
    dict(embed [V, Hp], w_ih / w_hh [L, Hp, 4Hp], b_ih [L, 4Hp] fp32, H, Hp),
    Hp the larger of H and E rounded up to the kernel's multiple of 64; the
    embedding is zero past E and each gate block of the kernels and the
    bias zero past H units (no copy of the table and no padding when Hp = H
    = E).

    The padding is exact: a padded unit's preactivations are 0, so i = f = o
    = sigmoid(0) = 0.5 and g = tanh(0) = 0 (bf16 chains included), c' =
    0.5 c and h' = 0.5 tanh(c'): a padded channel that starts at 0 stays 0,
    and the real channels never read it (its rows of the kernels are 0)."""
    L, H, E = len(w_hh), w_hh[0].shape[0], embed.shape[1]
    mult = LSTM_KERNEL_MULTIPLE
    Hp = -(-max(H, E) // mult) * mult
    shapes = [tuple(w.shape) for w in w_ih] + [tuple(w.shape) for w in w_hh]
    if shapes != [(E, 4 * H)] + [(H, 4 * H)] * (2 * L - 1) or len(b_ih) != L:
        raise ValueError(f"not an LSTM stack of width {H} on embeddings of {E}: {shapes}")
    bias = torch.stack([b.float() for b in b_ih])
    if Hp == H == E:
        return dict(embed=embed, w_ih=torch.stack(list(w_ih)), b_ih=bias,
                    w_hh=torch.stack(list(w_hh)), H=H, Hp=Hp)

    def pad_gates(x: torch.Tensor, rows: int) -> torch.Tensor:
        # [r, 4H] -> [rows, 4Hp]: gate g's H units at columns g Hp .. g Hp + H
        out = x.new_zeros((rows, 4, Hp))
        out[: x.shape[0], :, :H] = x.reshape(x.shape[0], 4, H)
        return out.reshape(rows, 4 * Hp)

    return dict(
        embed=torch.nn.functional.pad(embed, (0, Hp - E)),
        w_ih=torch.stack([pad_gates(w, Hp) for w in w_ih]),
        b_ih=pad_gates(bias, L),
        w_hh=torch.stack([pad_gates(w, Hp) for w in w_hh]),
        H=H,
        Hp=Hp,
    )


def rows_topk(
    row_vals: torch.Tensor, row_flat: torch.Tensor, n_cand: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-utterance top-n_cand from per-row winners ([B, K, n] each):
    a stable descending sort, so equal values keep the lower position first
    as ``lax.top_k`` does (``torch.topk`` promises no tie order)."""
    B = row_vals.shape[0]
    vals, pos = torch.sort(row_vals.reshape(B, -1), dim=1, descending=True, stable=True)
    vals, pos = vals[:, :n_cand], pos[:, :n_cand]
    return vals, row_flat.reshape(B, -1).gather(1, pos)


def _lse(x: torch.Tensor) -> torch.Tensor:
    m = x.max(1, keepdim=True).values
    return m + torch.log(torch.exp(x - m).sum(1, keepdim=True))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_joint_topk_reference(
    enc_t: torch.Tensor,  # [BK, J] encoder side (LN applied)
    feat: torch.Tensor,  # [BK, H] prediction-net features
    scores: torch.Tensor,  # [B, K] f32 beam scores
    w_dec: torch.Tensor,  # [H, J]
    b_dec: torch.Tensor,  # [J]
    ln_scale: torch.Tensor,  # [J]
    ln_bias: torch.Tensor,  # [J]
    w_out: torch.Tensor,  # [J, V]
    b_out: torch.Tensor,  # [V]
    K: int,
    n_cand: int,
    blank: int = 0,
    eos: Optional[int] = None,
    fold_eos_into_blank: bool = False,
    label_bias: Optional[torch.Tensor] = None,  # [BK, V] f32
):
    """Plain version of :func:`fused_joint_topk` (decode_kernels.py:144-217).

    Products take the operands' values (bf16 or fp32) and sum in fp32; the
    joint hidden rounds to the operand dtype before the vocab product, as in
    the TPU kernel. Returns (blank_lp [B, K] f32, row_vals [B, K, n] f32,
    row_flat [B, K, n] i32 flat indices into [K*V]) and, with a label bias,
    the per-row renormalisation factor [B, K] f32."""
    BK, V = enc_t.shape[0], w_out.shape[1]
    B = scores.shape[0]
    op = torch.promote_types(torch.promote_types(enc_t.dtype, feat.dtype), w_out.dtype)
    d = feat.float() @ w_dec.float() + b_dec.float()
    mu = d.mean(1, keepdim=True)
    var = ((d - mu) ** 2).mean(1, keepdim=True)
    d = (d - mu) * torch.rsqrt(var + LN_EPS)
    d = d * ln_scale.float() + ln_bias.float()
    h = torch.relu(enc_t.float() + d)
    logits = h.to(op).float() @ w_out.float() + b_out.float()
    lp = logits - _lse(logits)
    blank_col = lp[:, blank]
    fold = fold_eos_into_blank and eos is not None
    cols = torch.arange(V, device=lp.device)
    drop = cols == blank
    if fold:
        blank_col = torch.logaddexp(blank_col, lp[:, eos])
        drop = drop | (cols == eos)
    masked = lp.masked_fill(drop, NEG_INF)
    factor = None
    if label_bias is not None:
        fused = masked + label_bias.float()
        factor = _lse(masked) - _lse(fused)
        masked = fused + factor
    work = scores.float().reshape(BK, 1) + masked
    vals, idx = torch.sort(work, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :n_cand], idx[:, :n_cand]
    row = torch.arange(BK, device=lp.device)[:, None] % K
    flat = (row * V + idx).to(torch.int32)
    out = (blank_col.reshape(B, K).contiguous(), vals.reshape(B, K, n_cand), flat.reshape(B, K, n_cand))
    if factor is not None:
        return out + (factor.reshape(B, K),)
    return out


def lstm_step_reorder_reference(
    x: torch.Tensor,  # [BK, H] embedded tokens (destination-row order)
    S: torch.Tensor,  # [BK, 2LH] packed state
    src: torch.Tensor,  # [BK] source row of each destination row
    live: torch.Tensor,  # [BK] bool: rows that advance
    w_ih: torch.Tensor,  # [L, H, 4H]
    b_ih: torch.Tensor,  # [L, 4H]
    w_hh: torch.Tensor,  # [L, H, 4H]
    B: int,
    K: int,
) -> torch.Tensor:
    """Plain version of :func:`lstm_step_reorder`: gather the state rows by
    ``src``, advance every layer, keep the gathered state where ``live`` is
    false (dead rows still feed their computed hidden state to the next
    layer, decode_kernels.py:610-612). Computes in the state's dtype:

    * fp32: the JAX composition reorder -> ``pred_step`` -> live mask;
    * bf16: rounds where the TPU kernel and the CUDA kernel round
      (decode_kernels.py:574-609). ``pre = (x@w_ih + h@w_hh) + b`` sums
      exact bf16 products in fp32 and rounds to bf16; the gates are the TPU
      kernel's bf16 op chains, every step rounded to bf16:
      ``sigmoid(v) = 1 / (1 + exp(-v))``,
      ``tanh(v) = 2 / (1 + exp(-2v)) - 1``; then ``f*c``, ``i*g``, their
      sum ``c'``, ``tanh(c')`` (the same chain) and ``h' = o*tanh(c')``
      each round to bf16.
    """
    L = w_ih.shape[0]
    H = S.shape[1] // (2 * L)
    Sg = S[src.long()]
    alive = live[:, None]
    xl = x
    hs, cs = [], []
    for layer in range(L):
        hg = Sg[:, layer * H : (layer + 1) * H]
        cg = Sg[:, (L + layer) * H : (L + layer + 1) * H]
        pre = (xl.float() @ w_ih[layer].float() + hg.float() @ w_hh[layer].float()) + b_ih[
            layer
        ].float()
        if S.dtype == torch.bfloat16:
            h_new, c_new = _bf16_gates(pre.bfloat16(), cg)
        else:
            h_new, c_new = lstm_gates(pre.to(S.dtype), hg, cg)
        hs.append(torch.where(alive, h_new, hg))
        cs.append(torch.where(alive, c_new, cg))
        xl = h_new
    return torch.cat(hs + cs, 1)


def _bf16_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ``1 / (1 + exp(-v))`` on bf16, each op rounded."""
    return 1.0 / (1.0 + torch.exp(-v))


def _bf16_tanh(v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ``2 / (1 + exp(-2v)) - 1`` on bf16, each op rounded."""
    return 2.0 / (1.0 + torch.exp(-2.0 * v)) - 1.0


def _bf16_gates(pre: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = pre.chunk(4, dim=-1)
    c_new = _bf16_sigmoid(f) * c + _bf16_sigmoid(i) * _bf16_tanh(g)
    return _bf16_sigmoid(o) * _bf16_tanh(c_new), c_new


def aes_merge_reference(
    pool_scores: torch.Tensor,  # [B, K] f32
    blank_scores: torch.Tensor,  # [B, K] f32
    pool_hash: torch.Tensor,  # [B, K] i32
    exp_hash: torch.Tensor,  # [B, K] i32
    pool_ver: torch.Tensor,  # [B, K] i32
    pool_slot: torch.Tensor,  # [B, K] i32
    round_j: int,
    blank_lp: Optional[torch.Tensor] = None,  # [B, K] f32
):
    """Plain version of :func:`aes_merge` (decode_kernels.py:770-830): the
    [B, 2K] pool of (pool, expansion) columns, an exact logaddexp of equal
    hashes kept at the first occurrence (summed in column order, as the
    kernel sums), a stable top-K, and the bookkeeping gathers. With
    ``blank_lp`` the expansion scores are ``blank_scores + blank_lp``.
    Returns (top [B, K] f32, hash, version, slot, from_pool, src_slot [B, K]
    i32)."""
    B, K = pool_scores.shape
    dev = pool_scores.device
    i32 = torch.int32
    if blank_lp is not None:
        blank_scores = blank_scores.float() + blank_lp.float()
    merged = torch.cat([pool_scores.float(), blank_scores.float()], 1)
    hashes = torch.cat([pool_hash, exp_hash], 1).to(i32)
    kcols = torch.arange(K, device=dev, dtype=i32).expand(B, K)
    vers = torch.cat([pool_ver.to(i32), torch.full_like(kcols, round_j)], 1)
    slots = torch.cat([pool_slot.to(i32), kcols], 1)
    cols = torch.arange(2 * K, device=dev)
    eff = torch.where(merged > NEG_INF / 2, hashes, -(cols + 1).to(i32))
    eq = eff[:, :, None] == eff[:, None, :]
    vals = torch.where(eq, merged[:, None, :], NEG_INF)
    m = vals.max(2).values
    total = torch.zeros_like(m)
    for c in range(2 * K):
        total = total + torch.exp(vals[:, :, c] - m)
    comb = torch.where(m > NEG_INF / 2, m + torch.log(total), NEG_INF)
    first = eq.to(i32).argmax(2) == cols
    dedup = torch.where(first, comb, NEG_INF)
    top, sel = torch.sort(dedup, dim=1, descending=True, stable=True)
    top, sel = top[:, :K], sel[:, :K]
    from_pool = sel < K
    src = torch.where(from_pool, sel, sel - K)
    return (
        top,
        hashes.gather(1, sel),
        vers.gather(1, sel),
        slots.gather(1, sel),
        from_pool.to(i32),
        src.to(i32),
    )


def _gather_k(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[b, idx[b, k]], 0 where idx is outside [0, K) (the TPU kernel's
    select chain)."""
    K = tab.shape[1]
    ok = (idx >= 0) & (idx < K)
    return torch.where(ok, tab.gather(1, idx.clamp(0, K - 1).long()), 0)


def aes_backtrace_reference(
    active: torch.Tensor,  # [T, B] i32 (1 = frame within the source length)
    fp: torch.Tensor,  # [T, R, B, K] i32 from-pool flags per merge round
    msrc: torch.Tensor,  # [T, R, B, K] i32 merge source slots
    esrc: torch.Tensor,  # [T, E, B, K] i32 expansion source beams
    etok: torch.Tensor,  # [T, E, B, K] i32 expansion tokens
    order: torch.Tensor,  # [B, K] i32 initial (sorted) slots
    n_exp: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`aes_backtrace` (decode_kernels.py:338-366): a
    loop over the frames in reverse. Returns (toks, valid) [T, E, B, K] i32
    with rounds in the order r = n_exp..1."""
    T, R, B, K = fp.shape
    E = esrc.shape[1]
    toks = torch.zeros((T, E, B, K), dtype=torch.int32, device=fp.device)
    valid = torch.zeros_like(toks)
    slot = order.to(torch.int32)
    for t in range(T - 1, -1, -1):
        cont = (active[t] > 0)[:, None].expand(B, K)
        exit_level = torch.full_like(slot, -1)
        exit_slot = slot
        cur = slot
        for j in range(n_exp, -1, -1):
            f = _gather_k(fp[t, j], cur) > 0
            src = _gather_k(msrc[t, j], cur)
            newly = cont & ~f
            exit_level = torch.where(newly, j, exit_level)
            exit_slot = torch.where(newly, src, exit_slot)
            cur = torch.where(cont & f, src, cur)
            cont = cont & f
        s = exit_slot
        for idx_r, r in enumerate(range(n_exp, 0, -1)):
            m = exit_level >= r
            tok = _gather_k(etok[t, r - 1], s)
            src = _gather_k(esrc[t, r - 1], s)
            toks[t, idx_r] = torch.where(m, tok, 0)
            valid[t, idx_r] = m.to(torch.int32)
            s = torch.where(m, src, s)
        slot = s
    return toks, valid


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn(symbol: str):
    from espresso_tpu_torch.ops import cuda_build

    lib, argtypes = _SIGNATURES[symbol]
    fn = getattr(cuda_build.load(lib, LIBRARIES[lib]), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call the C entry ``symbol`` on ``device``'s current stream; raise on
    a CUDA error of the launch."""
    index = device.index  # a CUDA tensor's device always has its index
    # the current stream's handle, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    rc = _fn(symbol)(*args, index, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc}")


def _tensor_maps(symbol: str, count: int, *args) -> ctypes.Array:
    """``count`` TMA tensor maps encoded by the C entry ``symbol`` into a
    host buffer, which a launch passes on by value."""
    buf = ctypes.create_string_buffer(count * TMAP_BYTES)
    rc = _fn(symbol)(*args, ctypes.addressof(buf))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
    return buf


class _PerWeightSet:
    """What a kernel derives from a weight set (a layout, its tensor maps),
    made at the first call with those weight tensors and reused while they
    live and are not written in place (keyed on identity, storage and
    version counter); at most ``size`` sets are kept."""

    def __init__(self, make, size: int = 8):
        self._make, self._size = make, size
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def __call__(self, *weights: torch.Tensor):
        key = tuple((id(w), w.data_ptr(), w._version) for w in weights)
        hit = self._entries.get(key)
        if hit is not None and all(ref() is w for ref, w in zip(hit[0], weights)):
            self._entries.move_to_end(key)
            return hit[1]
        value = self._make(*weights)
        self._entries[key] = (tuple(weakref.ref(w) for w in weights), value)
        while len(self._entries) > self._size:
            self._entries.popitem(last=False)
        return value


def _route(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain
    version); raise for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _need(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def _on(name: str, dev: torch.device, dtype: torch.dtype, **tensors) -> None:
    for key, x in tensors.items():
        _need(name, x.device == dev and x.dtype == dtype, f"{key} must be {dtype} on {dev}")


def _contig(name: str, **tensors) -> None:
    for key, x in tensors.items():
        _need(
            name,
            x.is_contiguous() and x.data_ptr() % 16 == 0,
            f"{key} must be contiguous and 16-byte aligned",
        )


def _vec(x: torch.Tensor) -> torch.Tensor:
    """A float vector as contiguous fp32 (no copy when it already is)."""
    return x.float().contiguous()


def lstm_gate_interleave(H: int, device=None) -> torch.Tensor:
    """Row n of the kernel layout is row ``perm[n]`` of the gate kernels'
    transpose [4H, ...] (gate order i, f, g, o): n = 32 b + 8 gate + j
    holds gate ``gate`` of unit 8 b + j, so each 8-row group is one gate of
    8 units and the groups cycle i, f, g, o."""
    n = torch.arange(4 * H, device=device)
    return (n // 8 % 4) * H + n // 32 * 8 + n % 8


def lstm_kernel_layout(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The ``lstm_step_reorder`` kernel's weight layout: [L, H, 4H] gate
    kernels (``x @ w``) -> [L * 4H, 2H], layer l's rows the transpose of
    [w_ih[l]; w_hh[l]] with the gate columns in :func:`lstm_gate_interleave`
    order. A permutation: every weight appears once, unchanged."""
    L, H, _ = w_ih.shape
    w = torch.cat([w_ih, w_hh], 1).transpose(1, 2)  # [L, 4H, 2H]
    return w[:, lstm_gate_interleave(H, w.device)].reshape(L * 4 * H, 2 * H).contiguous()


def _make_lstm_weights(w_ih: torch.Tensor, w_hh: torch.Tensor):
    wk = lstm_kernel_layout(w_ih, w_hh)
    L, H = w_ih.shape[0], w_ih.shape[1]
    return wk, _tensor_maps("lstm_step_reorder_tmap", 1, wk.data_ptr(), L, H)


def _make_joint_weights(w_dec: torch.Tensor, w_out: torch.Tensor):
    wdT, woT = w_dec.t().contiguous(), w_out.t().contiguous()
    H, J, V = w_dec.shape[0], w_dec.shape[1], w_out.shape[1]
    _need("fused_joint_topk", wdT.data_ptr() % 16 == 0 and woT.data_ptr() % 16 == 0,
          "w_dec and w_out must be 16-byte aligned")
    tmaps = _tensor_maps("fused_joint_topk_tmaps", 2, wdT.data_ptr(), woT.data_ptr(), H, J, V)
    return wdT, woT, tmaps


# the widest J and H of the fused joint kernel's instance that keeps feat
# and h in shared memory, and of its wide instance
FUSED_JOINT_NARROW_WIDTH, FUSED_JOINT_MAX_WIDTH = 1024, 2048

_lstm_weights = _PerWeightSet(_make_lstm_weights)
_joint_weights = _PerWeightSet(_make_joint_weights)


def fused_joint_topk(
    enc_t: torch.Tensor,
    feat: torch.Tensor,
    scores: torch.Tensor,
    w_dec: torch.Tensor,
    b_dec: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    K: int,
    n_cand: int,
    blank: int = 0,
    eos: Optional[int] = None,
    fold_eos_into_blank: bool = False,
    label_bias: Optional[torch.Tensor] = None,
):
    """Fused joint + log-softmax + per-row top-n_cand (see the plain version
    for the function and the outputs). On the card the products take bf16:
    ``enc_t`` [BK, J] and ``w_dec``/``w_out`` bf16, ``feat`` bf16 [BK, H]
    with unit column stride (``lstm_feat``'s strided view is taken as is);
    ``scores`` and ``label_bias`` fp32; J a multiple of 64, H of 16,
    ``n_cand`` at most 32 and at most the unmasked vocab; J and H at most
    ``FUSED_JOINT_MAX_WIDTH`` (2048; above 1024 the kernel's wide instance
    runs, with a [BK, J] bf16 scratch for h). The weights are read as their
    transposes ([J, H] and [V, J], the
    ``nn.Linear`` layout; no copy when ``w_dec``/``w_out`` are transposed
    views of contiguous tensors) through TMA tensor maps encoded once per
    weight set. ``fused_joint_topk.launches`` counts kernel launches."""
    name = "fused_joint_topk"
    if not _route(name, enc_t):
        return fused_joint_topk_reference(
            enc_t, feat, scores, w_dec, b_dec, ln_scale, ln_bias, w_out, b_out,
            K, n_cand, blank, eos, fold_eos_into_blank, label_bias,
        )
    dev = enc_t.device
    BK, J = enc_t.shape
    H, V = feat.shape[1], w_out.shape[1]
    B = scores.shape[0]
    fold = fold_eos_into_blank and eos is not None
    _on(name, dev, torch.bfloat16, enc_t=enc_t, feat=feat, w_dec=w_dec, w_out=w_out)
    _on(name, dev, torch.float32, scores=scores)
    _need(name, BK == B * K and scores.shape == (B, K), f"scores {tuple(scores.shape)} for BK={BK}")
    _need(name, feat.shape[0] == BK, f"feat {tuple(feat.shape)} != [{BK}, H]")
    _need(name, w_dec.shape == (H, J) and w_out.shape[0] == J, "w_dec must be [H, J], w_out [J, V]")
    _need(name, J % 64 == 0 and H % 16 == 0, f"J={J} must be a multiple of 64, H={H} of 16")
    _need(name, 0 <= blank < V and (not fold or 0 <= eos < V), "blank/eos outside the vocab")
    _need(name, 1 <= n_cand <= min(MAX_CAND, V - 1 - int(fold and eos != blank)), f"n_cand={n_cand}")
    _need(
        name,
        feat.stride(1) == 1 and feat.stride(0) % 8 == 0 and feat.data_ptr() % 16 == 0,
        "feat rows must be unit-stride, 16-byte aligned",
    )
    _need(
        name, J <= FUSED_JOINT_MAX_WIDTH and H <= FUSED_JOINT_MAX_WIDTH,
        f"J={J} and H={H} must be at most {FUSED_JOINT_MAX_WIDTH}",
    )
    *_, tmaps = _joint_weights(w_dec, w_out)  # the transposes stay alive beside their maps
    vecs = [_vec(v) for v in (b_dec, ln_scale, ln_bias, b_out)]
    for key, v, n in zip(("b_dec", "ln_scale", "ln_bias", "b_out"), vecs, (J, J, J, V)):
        _need(name, v.device == dev and v.shape == (n,), f"{key} must be [{n}] on {dev}")
    _contig(name, enc_t=enc_t, scores=scores)
    bias_ptr = factor = None
    if label_bias is not None:
        _on(name, dev, torch.float32, label_bias=label_bias)
        _need(name, label_bias.shape == (BK, V), f"label_bias must be [{BK}, {V}]")
        _contig(name, label_bias=label_bias)
        bias_ptr = label_bias.data_ptr()
        factor = torch.empty(BK, dtype=torch.float32, device=dev)
    blank_lp = torch.empty(BK, dtype=torch.float32, device=dev)
    vals = torch.empty(BK, n_cand, dtype=torch.float32, device=dev)
    flat = torch.empty(BK, n_cand, dtype=torch.int32, device=dev)
    h_buf = None  # the wide instance's h, written and read back by the kernel
    if J > FUSED_JOINT_NARROW_WIDTH or H > FUSED_JOINT_NARROW_WIDTH:
        h_buf = torch.empty(BK, J, dtype=torch.bfloat16, device=dev)
    _launch(
        "fused_joint_topk_bf16", dev,
        enc_t.data_ptr(), feat.data_ptr(), feat.stride(0), scores.data_ptr(),
        ctypes.addressof(tmaps), None if h_buf is None else h_buf.data_ptr(),
        vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
        vecs[3].data_ptr(), bias_ptr,
        blank_lp.data_ptr(), vals.data_ptr(), flat.data_ptr(),
        None if factor is None else factor.data_ptr(),
        BK, H, J, V, K, n_cand, blank, eos if fold else -1,
    )
    fused_joint_topk.launches += 1
    out = (blank_lp.reshape(B, K), vals.reshape(B, K, n_cand), flat.reshape(B, K, n_cand))
    return out if factor is None else out + (factor.reshape(B, K),)


def lstm_step_reorder(
    x: torch.Tensor,
    S: torch.Tensor,
    src: torch.Tensor,
    live: torch.Tensor,
    w_ih: torch.Tensor,
    b_ih: torch.Tensor,
    w_hh: torch.Tensor,
    B: int,
    K: int,
) -> torch.Tensor:
    """Fused beam reorder + L-layer LSTM step + live mask on the packed state
    (see the plain version). Returns the new packed state [BK, 2LH]. On the
    card: ``x`` [BK, H], ``S`` and the weights bf16 (the kernel takes no
    other dtype), ``src`` int64 (int32 is converted), ``live`` bool, H a
    multiple of 64. The gate kernels are read in :func:`lstm_kernel_layout`,
    made with its TMA tensor map once per weight set. One launch per layer;
    ``lstm_step_reorder.launches`` counts calls."""
    name = "lstm_step_reorder"
    if not _route(name, S):
        return lstm_step_reorder_reference(x, S, src, live, w_ih, b_ih, w_hh, B, K)
    dev = S.device
    L = w_ih.shape[0]
    BK, C = S.shape
    H = C // (2 * L)
    _on(name, dev, torch.bfloat16, x=x, S=S, w_ih=w_ih, w_hh=w_hh)
    _need(name, BK == B * K and C == 2 * L * H, f"S {tuple(S.shape)} for B*K={B * K}, L={L}")
    _need(name, x.shape == (BK, H), f"x {tuple(x.shape)} != [{BK}, {H}] (embedding width must be H)")
    _need(name, w_ih.shape == (L, H, 4 * H) and w_hh.shape == (L, H, 4 * H), "w_ih/w_hh must be [L, H, 4H]")
    _need(name, H % 64 == 0, f"H={H} must be a multiple of 64")
    _need(name, src.device == dev and src.shape == (BK,), f"src must be [{BK}] on {dev}")
    _need(name, live.device == dev and live.dtype == torch.bool and live.shape == (BK,), "live must be [BK] bool")
    b = _vec(b_ih)
    _need(name, b.device == dev and b.shape == (L, 4 * H), f"b_ih must be [{L}, {4 * H}]")
    _, tmap = _lstm_weights(w_ih, w_hh)
    src64 = src.to(torch.int64).contiguous()
    live = live.contiguous()
    _contig(name, x=x, S=S)
    out = torch.empty_like(S)
    scratch = torch.empty((2, BK, H), dtype=torch.bfloat16, device=dev)
    _launch(
        "lstm_step_reorder_bf16", dev,
        x.data_ptr(), S.data_ptr(), src64.data_ptr(), live.data_ptr(), ctypes.addressof(tmap),
        b.data_ptr(), out.data_ptr(), scratch.data_ptr(), BK, H, L,
    )
    lstm_step_reorder.launches += 1
    return out


def aes_merge(
    pool_scores: torch.Tensor,
    blank_scores: torch.Tensor,
    pool_hash: torch.Tensor,
    exp_hash: torch.Tensor,
    pool_ver: torch.Tensor,
    pool_slot: torch.Tensor,
    round_j: int,
    blank_lp: Optional[torch.Tensor] = None,
):
    """One AES blank-merge round (see the plain version). With ``blank_lp``
    the kernel adds it to ``blank_scores`` (then the expansions' scores
    before the blank) as it loads them. On the card the scores and
    ``blank_lp`` are fp32 and the rest int32, all [B, K] and contiguous; any
    K. The six outputs are views of one [6, B, K] allocation.
    ``aes_merge.launches`` counts kernel launches."""
    name = "aes_merge"
    if not _route(name, pool_scores):
        return aes_merge_reference(
            pool_scores, blank_scores, pool_hash, exp_hash, pool_ver, pool_slot, round_j, blank_lp
        )
    dev = pool_scores.device
    B, K = pool_scores.shape
    f32, i32 = torch.float32, torch.int32
    ins = [("pool_scores", pool_scores, f32), ("blank_scores", blank_scores, f32),
           ("pool_hash", pool_hash, i32), ("exp_hash", exp_hash, i32),
           ("pool_ver", pool_ver, i32), ("pool_slot", pool_slot, i32)]
    if blank_lp is not None:
        ins.append(("blank_lp", blank_lp, f32))
    for key, x, dtype in ins:
        if x.device != dev or x.dtype != dtype or x.shape != (B, K) or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} [{B}, {K}] on {dev}, "
                             f"not {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty((6, B, K), dtype=i32, device=dev)
    _launch(
        "aes_merge_f32", dev, pool_scores.data_ptr(), blank_scores.data_ptr(),
        None if blank_lp is None else blank_lp.data_ptr(), pool_hash.data_ptr(),
        exp_hash.data_ptr(), pool_ver.data_ptr(), pool_slot.data_ptr(), round_j, B, K,
        out.data_ptr(), out.data_ptr() + B * K * 4,
    )
    aes_merge.launches += 1
    top, *ints = out.unbind(0)
    return (top.view(f32), *ints)


def aes_backtrace(
    active: torch.Tensor,
    fp: torch.Tensor,
    msrc: torch.Tensor,
    esrc: torch.Tensor,
    etok: torch.Tensor,
    order: torch.Tensor,
    n_exp: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse backpointer walk over all frames (see the plain version). On
    the card every input is contiguous int32; K at most 1024.
    ``aes_backtrace.launches`` counts kernel launches."""
    name = "aes_backtrace"
    if not _route(name, fp):
        return aes_backtrace_reference(active, fp, msrc, esrc, etok, order, n_exp)
    dev = fp.device
    T, R, B, K = fp.shape
    E = esrc.shape[1]
    ins = dict(active=active, fp=fp, msrc=msrc, esrc=esrc, etok=etok, order=order)
    _on(name, dev, torch.int32, **ins)
    _need(name, n_exp >= 1 and R == n_exp + 1 and E == n_exp, f"R={R}, E={E} for n_exp={n_exp}")
    _need(name, active.shape == (T, B) and msrc.shape == fp.shape, "active must be [T, B], msrc as fp")
    _need(name, esrc.shape == (T, E, B, K) and etok.shape == esrc.shape, "esrc/etok must be [T, E, B, K]")
    _need(name, order.shape == (B, K) and K <= 1024, f"order {tuple(order.shape)} (K <= 1024)")
    _contig(name, **ins)
    toks = torch.empty((T, E, B, K), dtype=torch.int32, device=dev)
    valid = torch.empty_like(toks)
    _launch(
        "aes_backtrace_i32", dev, *(x.data_ptr() for x in ins.values()), toks.data_ptr(), valid.data_ptr(),
        T, B, K, n_exp,
    )
    aes_backtrace.launches += 1
    return toks, valid


for _f in (fused_joint_topk, lstm_step_reorder, aes_merge, aes_backtrace):
    _f.launches = 0
KERNELS: Sequence = (fused_joint_topk, lstm_step_reorder, aes_merge, aes_backtrace)
