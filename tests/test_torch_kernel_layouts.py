"""The one-time weight layout of the ``lstm_step_reorder`` kernel, on the
CPU: a permutation of ``beam_kernel_weights``' gate kernels, whose inverse
gives them back exactly, with the gate columns interleaved as the kernel's
epilogue reads them."""

import pytest
import torch

from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import decode_kernels as dk


@pytest.mark.parametrize("H,L", [(64, 1), (128, 3)])
def test_lstm_kernel_layout_is_an_invertible_permutation(H, L):
    torch.manual_seed(H + L)
    cfg = TransducerConfig(
        feat_dim=8, vocab_size=16,
        encoder=SpeechTransformerConfig(
            encoder_embed_dim=32, encoder_ffn_dim=32, encoder_layers=1, encoder_heads=2,
        ),
        pred_embed_dim=H, pred_hidden_size=H, pred_layers=L, joint_dim=32,
    )
    _, pw = TransducerModel(cfg).beam_kernel_weights()
    w_ih, w_hh = pw["w_ih"], pw["w_hh"]  # [L, H, 4H]
    wk = dk.lstm_kernel_layout(w_ih, w_hh)
    assert wk.shape == (L * 4 * H, 2 * H) and wk.is_contiguous()

    perm = dk.lstm_gate_interleave(H)
    assert torch.equal(torch.sort(perm).values, torch.arange(4 * H))
    # each 8-row group is one gate (i, f, g, o in turn) of 8 consecutive units
    rows = perm.reshape(H // 8, 4, 8)
    assert torch.equal(rows // H, torch.arange(4)[None, :, None].expand_as(rows))
    units = rows % H
    assert torch.equal(units, units[:, :1].expand_as(units))
    assert torch.equal(units[:, 0].reshape(-1), torch.arange(H))

    back = wk.reshape(L, 4 * H, 2 * H)[:, torch.argsort(perm)].transpose(1, 2)
    assert torch.equal(back[:, :H], w_ih) and torch.equal(back[:, H:], w_hh)
