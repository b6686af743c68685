"""RNN-Transducer loss: the log-domain forward-backward DP and the lattice loss.

Counterpart of ``espresso_tpu/ops/rnnt.py``: ``_log_chain_scan``
(rnnt.py:30-44), ``_gather_transitions`` (:47-61), ``_forward_alpha``
(:64-115), ``_backward_beta`` (:118-169) and the lattice ``rnnt_loss``
(:240-255) with its analytic gradient (:192-234).

The alpha/beta DP is an XLA scan in JAX, not a TPU kernel, so it stays plain
PyTorch: a Python loop over frames, with each frame's U-recurrence
``x[u] = logaddexp(a[u], x[u-1] + c[u])`` solved by a log-domain doubling
scan (log2(U1) steps of whole-tensor ops). The closed form
``cumsum(c) + logcumsumexp(a - cumsum(c))`` is not used: ``c[0] = NEG_INF``
makes it lose all precision.

The lattice loss materialises the [B, T, U1, V] log-probs; the train path
uses the lattice-free fused loss (``ops/rnnt_fused.py``), and this one is its
oracle in the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e30


def _log_chain_scan(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve x[u] = logaddexp(a[u], x[u-1] + c[u]) along the last axis.

    The pairs (c, a) compose as (c1, a1)∘(c2, a2) = (c1 + c2,
    logaddexp(a1 + c2, a2)); a doubling (Hillis-Steele) scan applies the
    composition at offsets 1, 2, 4, ... ."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a_new = torch.logaddexp(a[..., : n - d] + c[..., d:], a[..., d:])
        c_new = c[..., : n - d] + c[..., d:]
        a = torch.cat([a[..., :d], a_new], dim=-1)
        c = torch.cat([c[..., :d], c_new], dim=-1)
        d *= 2
    return a


def _gather_transitions(
    log_probs: torch.Tensor, targets: torch.Tensor, blank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lp_blank [B, T, U1], lp_label [B, T, U1]); label column U is NEG_INF."""
    B, T, U1, V = log_probs.shape
    lp_blank = log_probs[..., blank]
    tgt = torch.cat(
        [targets.long(), torch.zeros(B, 1, dtype=torch.long, device=targets.device)], 1
    )
    lp_label = log_probs.gather(-1, tgt[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    u_idx = torch.arange(U1, device=log_probs.device)
    lp_label = torch.where(u_idx < U1 - 1, lp_label, torch.full_like(lp_label, NEG_INF))
    return lp_blank, lp_label


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, NEG_INF)


def _forward_alpha(
    lp_blank: torch.Tensor,
    lp_label: torch.Tensor,
    src_lengths: torch.Tensor,
    tgt_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """alpha [B, T, U1] and the per-example log-likelihood [B]."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    src_lengths, tgt_lengths = src_lengths.long(), tgt_lengths.long()
    u_idx = torch.arange(U1, device=dev)[None, :]
    valid_u = u_idx <= tgt_lengths[:, None]  # [B, U1]

    # t = 0: the label chain from the origin
    shifted0 = torch.cat([torch.zeros(B, 1, device=dev), lp_label[:, 0, :-1]], 1)
    alpha = torch.cumsum(shifted0, 1)
    alpha = torch.where(valid_u, alpha, _neg_inf(alpha))
    alphas = [alpha]
    for t in range(1, T):
        from_blank = alpha + lp_blank[:, t - 1]
        c = torch.cat([torch.full((B, 1), NEG_INF, device=dev), lp_label[:, t, :-1]], 1)
        alpha_t = _log_chain_scan(from_blank, c)
        alpha_t = torch.where(valid_u, alpha_t, _neg_inf(alpha_t))
        alpha = torch.where((t < src_lengths)[:, None], alpha_t, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, 1)  # [B, T, U1]

    # log Z = alpha[T_b - 1, U_b] + lp_blank[T_b - 1, U_b]
    rows = torch.arange(B, device=dev)
    t_last = (src_lengths - 1).clamp(min=0)
    logZ = alphas[rows, t_last, tgt_lengths] + lp_blank[rows, t_last, tgt_lengths]
    return alphas, logZ


def _backward_beta(
    lp_blank: torch.Tensor,
    lp_label: torch.Tensor,
    src_lengths: torch.Tensor,
    tgt_lengths: torch.Tensor,
) -> torch.Tensor:
    """beta [B, T, U1]: the log-prob of completing the lattice from (t, u)."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    src_lengths, tgt_lengths = src_lengths.long(), tgt_lengths.long()
    u_idx = torch.arange(U1, device=dev)[None, :]
    valid_u = u_idx <= tgt_lengths[:, None]
    rows = torch.arange(B, device=dev)

    beta = torch.full((B, U1), NEG_INF, device=dev)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        lpb_t, lpl_t = lp_blank[:, t], lp_label[:, t]
        # within-frame label chain (right to left), then the blank move to t+1;
        # reversing u aligns c_rev[r] with lp_label[t, u] directly
        from_blank = lpb_t + beta
        beta_t = torch.flip(
            _log_chain_scan(torch.flip(from_blank, [1]), torch.flip(lpl_t, [1])), [1]
        )
        beta_t = torch.where(valid_u, beta_t, _neg_inf(beta_t))
        # the last active frame: the labels still to emit, then the final blank
        masked_label = torch.where(u_idx < tgt_lengths[:, None], lpl_t, torch.zeros_like(lpl_t))
        suffix = torch.flip(torch.cumsum(torch.flip(masked_label, [1]), 1), [1])
        beta_last = suffix + lpb_t[rows, tgt_lengths][:, None]
        beta_last = torch.where(valid_u, beta_last, _neg_inf(beta_last))
        beta_t = torch.where((t == src_lengths - 1)[:, None], beta_last, beta_t)
        # frames past the end carry the next frame's beta
        beta = torch.where((t >= src_lengths)[:, None], beta, beta_t)
        betas[t] = beta
    return torch.stack(betas, 1)


def occupancies(
    lp_blank: torch.Tensor,
    lp_label: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    logZ: torch.Tensor,
    src_lengths: torch.Tensor,
    tgt_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancies of the blank move (t, u) -> (t+1, u) and of the label move
    (t, u) -> (t, u+1), each [B, T, U1] (rnnt.py:199-223, rnnt_pallas.py
    :434-455): d(-logZ)/d lp = -occupancy."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    src = src_lengths.long()[:, None, None]
    tgt = tgt_lengths.long()[:, None, None]
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    beta_next_t = torch.cat([betas[:, 1:], torch.full((B, 1, U1), NEG_INF, device=dev)], 1)
    is_terminal = (t_idx == src - 1) & (u_idx == tgt)
    beta_after_blank = torch.where(is_terminal, torch.zeros_like(beta_next_t), beta_next_t)
    occ_blank = torch.exp(alphas + lp_blank + beta_after_blank - logZ[:, None, None])
    beta_right = torch.cat([betas[:, :, 1:], torch.full((B, T, 1), NEG_INF, device=dev)], 2)
    occ_label = torch.exp(alphas + lp_label + beta_right - logZ[:, None, None])
    valid = (t_idx < src) & (u_idx <= tgt)
    occ_blank = torch.where(valid, occ_blank, torch.zeros_like(occ_blank))
    occ_label = torch.where(valid & (u_idx < tgt), occ_label, torch.zeros_like(occ_label))
    return occ_blank, occ_label


class _RnntLossFromLogProbs(torch.autograd.Function):
    """-logZ from the [B, T, U1, V] log-probs, with the analytic gradient."""

    @staticmethod
    def forward(ctx, log_probs, targets, src_lengths, tgt_lengths, blank):
        lp_blank, lp_label = _gather_transitions(log_probs, targets, blank)
        alphas, logZ = _forward_alpha(lp_blank, lp_label, src_lengths, tgt_lengths)
        ctx.save_for_backward(targets, src_lengths, tgt_lengths, lp_blank, lp_label, alphas, logZ)
        ctx.blank, ctx.vocab = blank, log_probs.shape[-1]
        return -logZ

    @staticmethod
    def backward(ctx, g):
        targets, src_lengths, tgt_lengths, lp_blank, lp_label, alphas, logZ = ctx.saved_tensors
        betas = _backward_beta(lp_blank, lp_label, src_lengths, tgt_lengths)
        occ_b, occ_l = occupancies(
            lp_blank, lp_label, alphas, betas, logZ, src_lengths, tgt_lengths
        )
        g3 = g[:, None, None]
        B, T, U1 = lp_blank.shape
        grad = torch.zeros(B, T, U1, ctx.vocab, device=g.device, dtype=lp_blank.dtype)
        grad[..., ctx.blank] -= occ_b * g3
        tgt = torch.cat(
            [targets.long(), torch.zeros(B, 1, dtype=torch.long, device=g.device)], 1
        )
        grad.scatter_add_(-1, tgt[:, None, :, None].expand(B, T, U1, 1), (-occ_l * g3)[..., None])
        return grad, None, None, None, None


def rnnt_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    src_lengths: torch.Tensor,
    tgt_lengths: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Per-example transducer NLL [B] from the joint lattice logits
    [B, T, U+1, V]; targets [B, U]; lengths [B]."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return _RnntLossFromLogProbs.apply(log_probs, targets, src_lengths, tgt_lengths, blank)
