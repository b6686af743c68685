"""CTC loss.

Counterpart of ``espresso_tpu/ops/ctc.py``'s ``ctc_loss`` (:23-101), with
JAX's semantics: the per-row negative log-likelihood over the extended
label sequence (blank, y1, blank, y2, ..., blank) of an f32 log-softmax; ``NEG_INF = -1e30`` for the impossible
states; a row frozen past its length, so that its read-out is at
``t = len - 1``; a skip from s - 2 only onto a label that differs from the
one two back; with ``zero_infinity`` a loss at or above 5e29 (a target too
long for its frames) is 0, and so is its gradient.

Why this form. The recipe's train runs are bit-reproducible on the card.
``torch.nn.functional.ctc_loss`` computes JAX's values, but PyTorch marks
its CUDA backward nondeterministic, and the CUDA backward of a ``gather``
is a scatter-add by atomics. Here the log-probs of the extended labels are
gathered (exact), and their gradient goes back onto the vocabulary through
a one-hot product (``_PickLabels``), summed in a fixed order; the forward
recursion is a Python loop over T' of elementwise ops, which autograd
differentiates as ``jax.grad`` differentiates JAX's scan. No op of either
direction sums by atomics. The loop costs ~41 device operations a frame,
forward and backward, on an H100 (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


class _PickLabels(torch.autograd.Function):
    """lp [B, T, V], ext [B, S] -> lp[b, t, ext[b, s]] [B, T, S]. Its
    gradient is summed onto the vocabulary by a product with the one-hot
    [B, S, V] of ``ext``: a fixed order, where gather's own backward adds by
    atomics on the card."""

    @staticmethod
    def forward(ctx, lp: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ext)
        ctx.vocab = lp.shape[-1]
        return lp.gather(2, ext[:, None, :].expand(-1, lp.shape[1], -1))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ext,) = ctx.saved_tensors
        onehot = (ext[:, :, None] == torch.arange(ctx.vocab, device=ext.device)).to(grad.dtype)
        return torch.bmm(grad, onehot), None


def _pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[b, index[b]] for x [B, S], as a masked sum (exact: every other term
    is 0), so that its gradient needs no scatter."""
    cols = torch.arange(x.shape[1], device=x.device)
    return torch.where(cols[None, :] == index[:, None], x, 0.0).sum(1)


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:
    """Per-row CTC negative log-likelihood [B] (f32).

    logits [B, T, V] unnormalised (any float dtype); logit_lengths [B];
    targets [B, U] without blanks; target_lengths [B]."""
    B, T, V = logits.shape
    U = targets.shape[1]
    S = 2 * U + 1
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = targets.long()
    lp_ext = _PickLabels.apply(lp, ext)  # [B, T, S]

    # a skip from s - 2 onto a label (odd s) that differs from ext[s - 2]
    ext_prev2 = F.pad(ext, (2, 0), value=blank)[:, :S]
    can_skip = (torch.arange(S, device=dev)[None, :] % 2 == 1) & (ext != ext_prev2)
    skip_mask = torch.where(can_skip, 0.0, NEG_INF)

    neg = torch.full((B, max(S - 2, 0)), NEG_INF, device=dev)
    first = lp_ext[:, 0, :2]
    if S > 1:
        first = torch.stack([first[:, 0], torch.where(target_lengths > 0, first[:, 1], NEG_INF)], 1)
    alpha = torch.cat([first, neg], 1)
    active = torch.arange(T, device=dev)[None, :] < logit_lengths[:, None]
    for t in range(1, T):
        diag = F.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        skip = F.pad(alpha, (2, 0), value=NEG_INF)[:, :S] + skip_mask
        new = torch.logaddexp(torch.logaddexp(alpha, diag), skip) + lp_ext[:, t]
        # rows past their length keep their alpha (read out at len - 1)
        alpha = torch.where(active[:, t : t + 1], new, alpha)

    last = 2 * target_lengths.long()
    ll_blank = _pick(alpha, last)
    ll_label = torch.where(target_lengths > 0, _pick(alpha, (last - 1).clamp(min=0)), NEG_INF)
    loss = -torch.logaddexp(ll_blank, ll_label)
    if zero_infinity:
        loss = torch.where(torch.isfinite(loss) & (loss < -NEG_INF / 2), loss, 0.0)
    return loss
