"""Transducer model: conformer encoder + LSTM prediction network + joint.

Counterpart of ``espresso_tpu/models/transducer.py`` (transducer.py:78-290):
for decoding, ``encode``, the single-token prediction step and the joint on
matched pairs, with the encoder side precomputable for all frames; for
training, the teacher-forced prediction net (``predict_sequence``) and the
lattice-free ``forward_fused``, whose outputs feed the fused RNNT loss. The
full-lattice ``__call__`` is not ported (the lattice criterion path is not).

The prediction-net carry is ``(h, c)``, each [L, B, H]; the JAX carry's
empty context and previous-token leaves are not kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.models.speech_transformer import (
    SpeechTransformerConfig,
    SpeechTransformerEncoder,
)
from espresso_tpu_torch.modules.conformer import LN_EPS
from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.modules.lstm import lstm_gates
from espresso_tpu_torch.registry import MODELS, register_architecture

Carry = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class TransducerConfig:
    name: str = "speech_transformer_transducer"
    feat_dim: int = 80
    vocab_size: int = 0
    encoder: SpeechTransformerConfig = field(
        default_factory=lambda: SpeechTransformerConfig(
            encoder_layer_type="conformer",
            encoder_pos_type="relative",
            encoder_embed_dim=512,
            encoder_ffn_dim=2048,
            encoder_layers=16,
            encoder_heads=8,
        )
    )
    # prediction network (2-layer LSTM)
    pred_embed_dim: int = 512
    pred_hidden_size: int = 512
    pred_layers: int = 2
    pred_dropout: float = 0.1
    # joint
    joint_dim: int = 512
    pad_index: int = 1  # set from the dictionary by the task; the model reads none


class TransducerPredNet(nn.Module):
    """LM-mode LSTM prediction network: embedding -> L LSTM cells (gate order
    i, f, g, o; the input projection carries the one bias)."""

    def __init__(
        self, vocab_size: int, embed_dim: int, hidden_size: int, layers: int,
        dropout: float = 0.0,
    ):
        super().__init__()
        H = hidden_size
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        self.cells_ih = nn.ModuleList(
            nn.Linear(embed_dim if i == 0 else H, 4 * H) for i in range(layers)
        )
        self.cells_hh = nn.ModuleList(
            nn.Linear(H, 4 * H, bias=False) for _ in range(layers)
        )
        self.dropout = Dropout(dropout)

    def step(self, carry: Carry, token: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """carry (h [L, B, H], c [L, B, H]), token [B] -> (new carry, feat [B, H])."""
        h_prev, c_prev = carry
        x = self.embed_tokens(token)
        hs, cs = [], []
        for i, (ih, hh) in enumerate(zip(self.cells_ih, self.cells_hh)):
            x, cell = lstm_gates(ih(x) + hh(h_prev[i]), h_prev[i], c_prev[i])
            hs.append(x)
            cs.append(cell)
        return (torch.stack(hs), torch.stack(cs)), x

    def sequence(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced features for all steps: [B, U] -> [B, U, H]
        (transducer.py:128-156). Each layer's input projection runs once for
        all steps; a loop over steps runs the recurrence. Dropout on the
        embedding and after each layer in train mode."""
        x = self.dropout(self.embed_tokens(tokens))
        for ih, hh in zip(self.cells_ih, self.cells_hh):
            x_proj = ih(x)  # [B, U, 4H]
            h = c = x_proj.new_zeros(x_proj.shape[0], hh.in_features)
            hs = []
            for u in range(x_proj.shape[1]):
                h, c = lstm_gates(x_proj[:, u] + hh(h), h, c)
                hs.append(h)
            x = self.dropout(torch.stack(hs, 1))
        return x


class JointNetwork(nn.Module):
    """relu(LN(W_enc enc) + LN(W_dec dec)) -> vocab."""

    def __init__(self, enc_dim: int, dec_dim: int, joint_dim: int, vocab_size: int):
        super().__init__()
        self.proj_enc = nn.Linear(enc_dim, joint_dim)
        self.proj_dec = nn.Linear(dec_dim, joint_dim)
        self.ln_enc = nn.LayerNorm(joint_dim, eps=LN_EPS)
        self.ln_dec = nn.LayerNorm(joint_dim, eps=LN_EPS)
        self.fc_out = nn.Linear(joint_dim, vocab_size)

    def pairwise(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """Matched pairs: enc [..., D_e], dec [..., D_d] -> [..., V]."""
        return self.pairwise_precomputed(self.enc_proj(enc), dec)

    def enc_proj(self, enc: torch.Tensor) -> torch.Tensor:
        """Encoder-side projection, precomputable for all frames at once."""
        return self.ln_enc(self.proj_enc(enc))

    def dec_proj(self, dec: torch.Tensor) -> torch.Tensor:
        """Prediction-side projection (the fused loss path)."""
        return self.ln_dec(self.proj_dec(dec))

    def pairwise_precomputed(
        self, enc_projected: torch.Tensor, dec: torch.Tensor
    ) -> torch.Tensor:
        return self.fc_out(F.relu(enc_projected + self.dec_proj(dec)))


@MODELS.register("speech_transformer_transducer", TransducerConfig)
class TransducerModel(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        cfg.encoder.feat_dim = cfg.feat_dim
        self.encoder = SpeechTransformerEncoder(cfg.encoder)
        self.predictor = TransducerPredNet(
            cfg.vocab_size, cfg.pred_embed_dim, cfg.pred_hidden_size, cfg.pred_layers,
            cfg.pred_dropout,
        )
        self.joint = JointNetwork(
            cfg.encoder.encoder_embed_dim,
            cfg.pred_hidden_size,
            cfg.joint_dim,
            cfg.vocab_size,
        )

    def encode(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        return self.encoder(src_frames, src_lengths)

    def predict_sequence(self, prev_output_tokens: torch.Tensor) -> torch.Tensor:
        """Prediction-net features for all steps: [B, U] -> [B, U, H]."""
        return self.predictor.sequence(prev_output_tokens)

    def forward_fused(
        self,
        src_frames: torch.Tensor,
        src_lengths: torch.Tensor,
        prev_output_tokens: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, EncoderOut]:
        """Lattice-free training forward (transducer.py:268-284): (enc_proj
        [B, T, J], dec_proj [B, U+1, J], encoder_out) for
        ``ops/rnnt_fused.RnntLossFused``."""
        enc = self.encoder(src_frames, src_lengths)
        pred = self.predict_sequence(prev_output_tokens)
        return self.joint.enc_proj(enc.encoder_out), self.joint.dec_proj(pred), enc

    def init_pred_carry(
        self, batch_size: int, dtype=torch.float32, device=None
    ) -> Carry:
        shape = (self.cfg.pred_layers, batch_size, self.cfg.pred_hidden_size)
        return (
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    def pred_step(self, tokens: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """One prediction-net step: tokens [B] -> (pred_feat [B, H], carry)."""
        carry, feat = self.predictor.step(carry, tokens)
        return feat, carry

    def joint_step(self, enc_frame: torch.Tensor, pred_feat: torch.Tensor) -> torch.Tensor:
        """Joint on matched pairs: [B, D_e] x [B, H] -> [B, V] logits."""
        return self.joint.pairwise(enc_frame, pred_feat)

    def joint_enc_proj(self, enc_out: torch.Tensor) -> torch.Tensor:
        """Precompute the joint's encoder projection: [B, T, D_e] -> [B, T, J]."""
        return self.joint.enc_proj(enc_out)

    def joint_step_precomputed(
        self, enc_projected: torch.Tensor, pred_feat: torch.Tensor
    ) -> torch.Tensor:
        """Joint with precomputed encoder side: [B, J] x [B, H] -> [B, V]."""
        return self.joint.pairwise_precomputed(enc_projected, pred_feat)

    @torch.no_grad()
    def beam_kernel_weights(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The weights of the decode kernels in their layout (counterpart of
        the extraction in espresso_tpu/decode/transducer_beam.py:247-328):

        * joint, for ``fused_joint_topk``: ``w_dec`` [H, J] and ``w_out``
          [J, V] as transposed views of the ``nn.Linear`` weights (no copy;
          the kernel reads the Linear layout), ``b_dec``, ``ln_scale``,
          ``ln_bias`` and ``b_out`` in fp32;
        * prediction net, for ``lstm_step_reorder``: the cell stack through
          ``prep_lstm_kernel_inputs`` (the embedding table ``embed`` [V, Hp],
          the stacked ``w_ih``/``w_hh`` [L, Hp, 4Hp], ``b_ih`` [L, 4Hp]
          fp32, ``H`` and ``Hp``): Hp = H when the embedding width is H and
          H a multiple of 64, else the stack is gate-padded to Hp.

        The stacks are copies: weights loaded later need a new call."""
        from espresso_tpu_torch.ops.decode_kernels import prep_lstm_kernel_inputs

        j, p = self.joint, self.predictor
        joint = dict(
            w_dec=j.proj_dec.weight.t(),
            b_dec=j.proj_dec.bias.float(),
            ln_scale=j.ln_dec.weight.float(),
            ln_bias=j.ln_dec.bias.float(),
            w_out=j.fc_out.weight.t(),
            b_out=j.fc_out.bias.float(),
        )
        pred = prep_lstm_kernel_inputs(
            p.embed_tokens.weight, [m.weight.t() for m in p.cells_ih],
            [m.bias for m in p.cells_ih], [m.weight.t() for m in p.cells_hh],
        )
        return joint, pred


@register_architecture("speech_transformer_transducer", "conformer_transducer_librispeech")
def _arch_conformer_transducer(cfg: TransducerConfig):
    # the reference recipe's operating point (espresso_tpu/models/
    # transducer.py:293-310, conformer_transducer_librispeech.yaml:28-92)
    cfg.encoder.encoder_layer_type = "conformer"
    cfg.encoder.encoder_pos_type = "relative"
    cfg.encoder.encoder_embed_dim = 512
    cfg.encoder.encoder_ffn_dim = 2048
    cfg.encoder.encoder_layers = 16
    cfg.encoder.encoder_heads = 8
    cfg.encoder.depthwise_conv_kernel_size = 31
    cfg.pred_layers = 2
    cfg.pred_hidden_size = 512
    cfg.joint_dim = 512
