"""Inputs and checks that hold each training kernel against its plain
version on the card, shared by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Each ``*_inputs`` makes seeded inputs at a given shape on a given device;
each ``check_*`` runs the wrappers (which launch their kernels) and the
plain versions on the same inputs, raises ``AssertionError`` on a
disagreement beyond the stated bound, and returns the max errors.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import torch

from espresso_tpu_torch.ops import attention_kernels as ak
from espresso_tpu_torch.ops import rnnt_kernels as rk
from espresso_tpu_torch.ops.rnnt import _backward_beta, _forward_alpha, occupancies

Tensors = Dict[str, torch.Tensor]

# rel_attention_train forward: the kernel rounds where the plain version
# rounds but sums in another order, so a score or a weight can round to the
# neighbouring bf16 value; that moves an output by about one bf16 ulp of
# its magnitude: 2 ulps, as for the inference kernel
ATTN_OUT_ULPS = 2
# backward: ds is formed from w and sum(dw w), each summed in another order,
# then rounded to bf16, and every gradient sums T (dp: B T) products of it;
# flipped roundings of ds add up over those sums: 8 bf16 ulps of each
# gradient's largest magnitude, still far below the O(1) error of a wrong
# index or mask
ATTN_GRAD_ULPS = 8
# rnnt_joint_lp: the same bf16 joint hidden in both, the logits summed over
# J = 512 in another order (~1e-5 relative) and the logsumexp merged in
# another order: 1e-3 absolute on log-probs of magnitude ~10
LP_ATOL = 1e-3
# the loss -logZ from the kernel's and the plain version's log-probs: the
# DP sums T' + U of them, each within LP_ATOL: 1e-4 relative
LOSS_RTOL = 1e-4
# rnnt_joint_bwd: glog rounds to bf16 before the products; a p that differs
# in its last f32 bits can round glog to the neighbouring bf16 value, one
# term of a sum over ~4e5 rows (g_W, g_b) or V columns (g_enc, g_dec): 1e-3
# of each gradient's largest magnitude; f32 atomics sum in a changing order
GRAD_REL = 1e-3


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


# ---------------------------------------------------------------------------
# rel_attention_train
# ---------------------------------------------------------------------------


def attention_train_inputs(B: int, T: int, seed: int, dev, H: int = 8) -> Tensors:
    """bf16 q+u, q+v, k, v [B, T, H*64], p [2T-1, H*64] and upstream g at unit
    scale; a ragged key mask (the first utterance full); an int32 seed."""
    D = H * ak.HEAD_DIM
    g = _gen(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    return dict(
        q_u=mk(B, T, D), q_v=mk(B, T, D), k=mk(B, T, D), v=mk(B, T, D), p=mk(2 * T - 1, D),
        key_valid=(torch.arange(T)[None, :] < lens[:, None]).to(dev),
        g=mk(B, T, D),
        seed=torch.randint(0, 2**31 - 1, (1,), generator=g, dtype=torch.int32).to(dev),
    )


def _attn_args(a: Tensors):
    return a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"]


def check_attention_train_fwd(a: Tensors, H: int, rate: float) -> float:
    """The forward kernel alone (one launch) against the plain version;
    returns the max abs error of the output."""
    scale = ak.HEAD_DIM ** -0.5
    before = ak.rel_attention_train_fwd.launches
    out = ak.rel_attention_train_fwd(*_attn_args(a), a["seed"], H, scale, rate)
    torch.cuda.synchronize()
    assert ak.rel_attention_train_fwd.launches == before + 1
    ref = ak.rel_attention_train_reference(*_attn_args(a), H, scale, rate, a["seed"])
    return _held("out", out, ref, ATTN_OUT_ULPS, rate, a)


def _held(name, x, r, ulps, rate, a) -> float:
    x, r = x.float(), r.float()
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"rel_attention_train {name}: not finite")
    err = (x - r).abs().max().item()
    bound = ulps * bf16_ulp(r.abs().max().item())
    if err > bound:
        raise AssertionError(
            f"rel_attention_train {name} at rate {rate}, shape {tuple(a['q_u'].shape)}: "
            f"max error {err} > {bound}"
        )
    return err


def check_attention_train(a: Tensors, H: int, rate: float) -> Dict[str, float]:
    """Forward and backward kernels against the plain versions; returns the
    max abs error of the output and of each gradient."""
    scale = ak.HEAD_DIM ** -0.5
    out = ak.rel_attention_train_fwd(*_attn_args(a), a["seed"], H, scale, rate)
    grads = ak.rel_attention_train_bwd(*_attn_args(a), a["seed"], a["g"], H, scale, rate)
    torch.cuda.synchronize()
    ref = ak.rel_attention_train_reference(*_attn_args(a), H, scale, rate, a["seed"])
    ref_grads = ak.rel_attention_train_backward_reference(
        *_attn_args(a), a["g"], H, scale, rate, a["seed"]
    )
    return {
        name: _held(name, x, r, ulps, rate, a)
        for name, x, r, ulps in [("out", out, ref, ATTN_OUT_ULPS)] + [
            (n, x, r, ATTN_GRAD_ULPS)
            for n, x, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, ref_grads)
        ]
    }


# a layer whose relative table is clipped (L < T'): its bf16 gradients
# through the train kernels against autograd through the layer's gather path
# in f32; the kernels round the scores, weights and ds to bf16, and each
# weight gradient sums B T' such products: 5 % of the gradient's norm, far
# below what a wrong row of the expanded table gives (O(1))
CLIPPED_GRAD_REL = 0.05


def long_attention_inputs(B: int, T: int, seed: int, dev, H: int = 2):
    """Arguments of ``rel_attention`` at a long T': bf16 q+u, q+v, k, v
    [B, T, H*64], p [2T-1, H*64], ragged key masks (the first utterance
    full, from B = 3 on the last with one valid key), H, the scale."""
    D = H * ak.HEAD_DIM
    g = _gen(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    if B >= 3:
        lens[-1] = 1
    key_valid = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid, H, \
        ak.HEAD_DIM ** -0.5


def check_rel_attention(*args) -> float:
    """The inference kernel (one launch) against its plain version at
    ``rel_attention``'s arguments; 2 bf16 ulps of the output's largest
    magnitude (as ATTN_OUT_ULPS). Returns the max abs error."""
    before = ak.rel_attention.launches
    out = ak.rel_attention(*args)
    torch.cuda.synchronize()
    assert ak.rel_attention.launches == before + 1
    ref = ak.rel_attention_reference(*args)
    err = (out.float() - ref.float()).abs().max().item()
    bound = ATTN_OUT_ULPS * bf16_ulp(ref.float().abs().max().item())
    if not bool(torch.isfinite(out.float()).all()) or err > bound:
        raise AssertionError(f"rel_attention at {tuple(args[0].shape)}: max error {err} > {bound}")
    return err


def check_clipped_table_layer(dev, T: int, L: int, B: int = 2, D: int = 512, H: int = 8):
    """A bf16 ``MultiheadAttention`` (dropout 0, its output projection
    taken out so that its output is the attention's context) on a relative
    table clipped at L < T: in eval one ``rel_attention`` launch, the
    context within ATTN_OUT_ULPS of the layer's own gather path (weights
    requested); in train one launch of each train kernel, the context within
    ATTN_OUT_ULPS of the gather path and the gradients of q, k, v, the
    position projection and the position biases within CLIPPED_GRAD_REL of
    autograd through the gather path of an f32 copy. Returns the max
    errors."""
    from torch import nn

    from espresso_tpu_torch.modules.attention import MultiheadAttention
    from espresso_tpu_torch.modules.positional import RelativePositionalEmbedding

    g = _gen(T + L)
    mha = MultiheadAttention(D, H)
    with torch.no_grad():
        for prm in mha.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * (0.1 if prm.dim() < 2 else D ** -0.5))
    mha.out_proj = nn.Identity()
    mha = mha.to(dev, torch.bfloat16)
    mha32 = copy.deepcopy(mha).float()
    rel = RelativePositionalEmbedding(D, L)(T).to(dev, torch.bfloat16)
    assert rel.shape == (2 * L - 1, D)
    x = torch.randn(B, T, D, generator=g).to(dev, torch.bfloat16)
    mask = (torch.arange(T)[None, :] < torch.tensor([T, 2 * T // 3])[:, None]).to(dev)

    def held(name, got, want, bound):
        err = (got.float() - want.float()).abs().max().item()
        if not bool(torch.isfinite(got.float()).all()) or err > bound:
            raise AssertionError(f"clipped table, {name}: max error {err} > {bound}")
        return err

    errs = {}
    mha.eval()
    before = ak.rel_attention.launches
    with torch.no_grad():
        out = mha(x, x, x, rel, key_padding_mask=mask)[0]
        ref = mha(x, x, x, rel, key_padding_mask=mask, need_weights=True)[0]
    torch.cuda.synchronize()
    assert ak.rel_attention.launches == before + 1, "eval did not launch rel_attention once"
    errs["eval"] = held("eval", out, ref, ATTN_OUT_ULPS * bf16_ulp(ref.float().abs().max().item()))

    up = torch.randn(B, T, D, generator=g).to(dev, torch.bfloat16)
    leaves = lambda m: [m.q_proj.weight, m.k_proj.weight, m.v_proj.weight, m.pos_proj.weight,
                        m.pos_bias_u, m.pos_bias_v]
    mha32.eval()
    x32 = x.float()
    ref32 = mha32(x32, x32, x32, rel.float(), key_padding_mask=mask, need_weights=True)[0]
    ref_grads = torch.autograd.grad(ref32, leaves(mha32), up.float())
    with torch.no_grad():
        ref = mha.eval()(x, x, x, rel, key_padding_mask=mask, need_weights=True)[0]
    mha.train()
    before = (ak.rel_attention_train_fwd.launches, ak.rel_attention_train_bwd.launches)
    out = mha(x, x, x, rel, key_padding_mask=mask)[0]
    grads = torch.autograd.grad(out, leaves(mha), up)
    torch.cuda.synchronize()
    assert (ak.rel_attention_train_fwd.launches, ak.rel_attention_train_bwd.launches) == (
        before[0] + 1, before[1] + 1), "train did not launch the train kernels once each"
    errs["train"] = held("train", out, ref, ATTN_OUT_ULPS * bf16_ulp(ref.float().abs().max().item()))
    for name, gk, gp in zip(("q", "k", "v", "pos", "bias_u", "bias_v"), grads, ref_grads):
        rel_err = ((gk.float() - gp.float()).norm() / gp.float().norm()).item()
        if not rel_err <= CLIPPED_GRAD_REL:
            raise AssertionError(f"clipped table, gradient of {name}: {rel_err} > {CLIPPED_GRAD_REL}")
        errs[f"grad_{name}"] = rel_err
    return errs


# ---------------------------------------------------------------------------
# rnnt_joint_lp / rnnt_joint_bwd
# ---------------------------------------------------------------------------


def rnnt_inputs(B, T, U, J, V, seed, dev, blank=0) -> Tensors:
    """bf16 joint projections at LayerNorm scale, output weights at
    ``nn.Linear``'s init scale (as a transposed [V, J] view) and a bf16
    bias; targets in the vocab but never blank; ragged source and target
    lengths (the first utterance full)."""
    g = _gen(seed)
    bf = lambda x: x.to(dev, torch.bfloat16)
    uni = lambda *s: (torch.rand(*s, generator=g) * 2 - 1) / math.sqrt(J)
    tgt = torch.randint(0, V - 1, (B, U), generator=g)
    tgt = tgt + (tgt >= blank).long()
    src = torch.randint(max(1, T // 2), T + 1, (B,), generator=g)
    tl = torch.randint(0, U + 1, (B,), generator=g)
    src[0], tl[0] = T, U
    return dict(
        enc_proj=bf(torch.randn(B, T, J, generator=g)),
        dec_proj=bf(torch.randn(B, U + 1, J, generator=g)),
        fc_kernel=bf(uni(V, J)).t(),
        fc_bias=bf(uni(V)),
        targets=tgt.to(dev, torch.int32),
        src_lengths=src.to(dev, torch.int32),
        tgt_lengths=tl.to(dev, torch.int32),
    )


def _joint_args(a: Tensors):
    return a["enc_proj"], a["dec_proj"], a["fc_kernel"], a["fc_bias"], a["targets"]


def occupancy_grads(a: Tensors, lpb, lpl):
    """(occb_n, occl_n): the blank and label occupancies of the lattice,
    negated (the upstream gradient of the loss is 1)."""
    alphas, logZ = _forward_alpha(lpb, lpl, a["src_lengths"], a["tgt_lengths"])
    betas = _backward_beta(lpb, lpl, a["src_lengths"], a["tgt_lengths"])
    ob, ol = occupancies(lpb, lpl, alphas, betas, logZ, a["src_lengths"], a["tgt_lengths"])
    return (-ob).contiguous(), (-ol).contiguous()


def check_rnnt_joint_lp(a: Tensors, blank: int):
    """``rnnt_joint_lp`` against its plain version, and the loss of each;
    returns the max abs error of each output and the loss's relative error,
    and the plain version's outputs."""
    lp = rk.rnnt_joint_lp(*_joint_args(a), blank)
    torch.cuda.synchronize()
    lp_ref = rk.rnnt_joint_lp_reference(*_joint_args(a), blank)
    errs = {}
    for name, x, r in zip(("lp_blank", "lp_label", "lse"), lp, lp_ref):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"rnnt_joint_lp {name}: not finite")
        err = (x - r).abs().max().item()
        if err > LP_ATOL:
            raise AssertionError(f"rnnt_joint_lp {name}: max error {err} > {LP_ATOL}")
        errs[name] = err
    loss = -_forward_alpha(lp[0], lp[1], a["src_lengths"], a["tgt_lengths"])[1]
    loss_ref = -_forward_alpha(lp_ref[0], lp_ref[1], a["src_lengths"], a["tgt_lengths"])[1]
    err = ((loss - loss_ref).abs() / loss_ref.abs()).max().item()
    if not err <= LOSS_RTOL:
        raise AssertionError(f"rnnt loss from rnnt_joint_lp: relative error {err} > {LOSS_RTOL}")
    errs["loss_rel"] = err
    return errs, lp_ref


def check_rnnt_joint(a: Tensors, blank: int) -> Dict[str, float]:
    """``rnnt_joint_lp`` and ``rnnt_joint_bwd`` against their plain versions
    (the backward fed the plain forward's lse and the DP's occupancies);
    returns the max abs error of each output."""
    errs, lp_ref = check_rnnt_joint_lp(a, blank)
    ob, ol = occupancy_grads(a, lp_ref[0], lp_ref[1])
    grads = rk.rnnt_joint_bwd(*_joint_args(a), lp_ref[2], ob, ol, blank)
    torch.cuda.synchronize()
    ref = rk.rnnt_joint_bwd_reference(*_joint_args(a), lp_ref[2], ob, ol, blank)
    for name, x, r in zip(("g_enc", "g_dec", "g_W", "g_b"), grads, ref):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"rnnt_joint_bwd {name}: not finite")
        err = (x - r).abs().max().item()
        bound = GRAD_REL * r.abs().max().item()
        if err > bound:
            raise AssertionError(f"rnnt_joint_bwd {name}: max error {err} > {bound}")
        errs[name] = err
    return errs


def check_rnnt_joint_bwd_repeats(a: Tensors, blank: int) -> None:
    """Two ``rnnt_joint_bwd`` launches on the same inputs give the same bits
    in all four outputs (its slots are summed in a fixed order). Between
    them the freed memory is filled with NaN, so that a slot the sum reads
    but no block stored would show."""
    lp = rk.rnnt_joint_lp_reference(*_joint_args(a), blank)
    ob, ol = occupancy_grads(a, lp[0], lp[1])
    first = rk.rnnt_joint_bwd(*_joint_args(a), lp[2], ob, ol, blank)
    torch.cuda.synchronize()
    sched = rk.joint_bwd_schedule(*first[0].shape[:2], first[1].shape[1], first[3].shape[0],
                                  torch.cuda.get_device_properties(first[0].device).multi_processor_count)
    ws = sum(rk.joint_bwd_workspace(sched, first[0].shape[2]).values())
    torch.full((ws + first[0].numel(),), float("nan"), device=first[0].device)
    second = rk.rnnt_joint_bwd(*_joint_args(a), lp[2], ob, ol, blank)
    torch.cuda.synchronize()
    for name, x, y in zip(("g_enc", "g_dec", "g_W", "g_b"), first, second):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"rnnt_joint_bwd {name}: not finite on the second launch")
        if not torch.equal(x, y):
            raise AssertionError(f"rnnt_joint_bwd {name}: two launches differ by "
                                 f"{(x - y).abs().max().item()}")
