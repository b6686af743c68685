"""Lattice-free transducer loss: the loss of the train criterion.

Counterpart of ``espresso_tpu/ops/rnnt_fused.py::rnnt_loss_fused``
(rnnt_fused.py:145-172) on its kernel path, ``rnnt_loss_fused_pallas``
(rnnt_pallas.py:396-476). ``RnntLossFused`` runs the joint kernels of
``ops/rnnt_kernels.py`` around the DP of ``ops/rnnt.py``: forward, B4 then
the alpha DP; backward, the beta DP, the occupancies and B5. The port always
takes the kernels: they take any V and mask its ragged tail, so neither
JAX's ``ESPRESSO_RNNT_PALLAS`` switch and shape gate nor its XLA chunked
path (rnnt_fused.py:175-350, the fallback for shapes the TPU kernel refuses,
computing the same function) is ported.
"""

from __future__ import annotations

import torch

# the kernels are looked up on their module at each call, so a comparison
# can route them to their plain versions
from espresso_tpu_torch.ops import rnnt_kernels
from espresso_tpu_torch.ops.rnnt import _backward_beta, _forward_alpha, occupancies


class RnntLossFused(torch.autograd.Function):
    """Per-example transducer NLL [B] from enc_proj [B, T, J], dec_proj
    [B, U1, J], fc_kernel [J, V], fc_bias [V], targets [B, U1-1],
    src_lengths [B] and tgt_lengths [B] (<= U1-1); the [B, T, U1, V] lattice
    is never materialised."""

    @staticmethod
    def forward(ctx, enc_proj, dec_proj, fc_kernel, fc_bias, targets, src_lengths, tgt_lengths, blank):
        lpb, lpl, lse = rnnt_kernels.rnnt_joint_lp(enc_proj, dec_proj, fc_kernel, fc_bias, targets, blank)
        alphas, logZ = _forward_alpha(lpb, lpl, src_lengths, tgt_lengths)
        ctx.save_for_backward(
            enc_proj, dec_proj, fc_kernel, fc_bias, targets, src_lengths, tgt_lengths,
            lpb, lpl, lse, alphas, logZ,
        )
        ctx.blank = blank
        return -logZ

    @staticmethod
    def backward(ctx, g):
        (enc_proj, dec_proj, fc_kernel, fc_bias, targets, src_lengths, tgt_lengths,
         lpb, lpl, lse, alphas, logZ) = ctx.saved_tensors
        betas = _backward_beta(lpb, lpl, src_lengths, tgt_lengths)
        occ_b, occ_l = occupancies(lpb, lpl, alphas, betas, logZ, src_lengths, tgt_lengths)
        # loss = -logZ, so d loss / d lp = -occ; the upstream g folds in here
        g3 = g.float()[:, None, None]
        g_enc, g_dec, g_W, g_b = rnnt_kernels.rnnt_joint_bwd(
            enc_proj, dec_proj, fc_kernel, fc_bias, targets, lse,
            (-occ_b * g3).contiguous(), (-occ_l * g3).contiguous(), ctx.blank,
        )
        return (
            g_enc.to(enc_proj.dtype), g_dec.to(dec_proj.dtype), g_W.to(fc_kernel.dtype),
            g_b.to(fc_bias.dtype), None, None, None, None,
        )
