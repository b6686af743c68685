"""Transducer model: conformer encoder + LSTM prediction network + joint.

Counterpart of ``espresso_tpu/models/transducer.py`` (transducer.py:78-290)
for decoding: ``encode``, the single-token prediction step and the joint on
matched pairs, with the encoder side precomputable for all frames. The
teacher-forced ``sequence`` path, the full lattice and the fused loss forward
wait for the train slice.

The prediction-net carry is ``(h, c)``, each [L, B, H]; the JAX carry's
empty context and previous-token leaves are not kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.models.speech_transformer import (
    SpeechTransformerConfig,
    SpeechTransformerEncoder,
)
from espresso_tpu_torch.modules.conformer import LN_EPS
from espresso_tpu_torch.modules.lstm import lstm_gates

Carry = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class TransducerConfig:
    feat_dim: int = 80
    vocab_size: int = 0
    encoder: SpeechTransformerConfig = field(
        default_factory=lambda: SpeechTransformerConfig(
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
    # joint
    joint_dim: int = 512


class TransducerPredNet(nn.Module):
    """LM-mode LSTM prediction network: embedding -> L LSTM cells."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden_size: int, layers: int):
        super().__init__()
        H = hidden_size
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        self.cells_ih = nn.ModuleList(
            nn.Linear(embed_dim if i == 0 else H, 4 * H) for i in range(layers)
        )
        self.cells_hh = nn.ModuleList(
            nn.Linear(H, 4 * H, bias=False) for _ in range(layers)
        )

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

    def pairwise_precomputed(
        self, enc_projected: torch.Tensor, dec: torch.Tensor
    ) -> torch.Tensor:
        d = self.ln_dec(self.proj_dec(dec))
        return self.fc_out(F.relu(enc_projected + d))


class TransducerModel(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        cfg.encoder.feat_dim = cfg.feat_dim
        self.encoder = SpeechTransformerEncoder(cfg.encoder)
        self.predictor = TransducerPredNet(
            cfg.vocab_size, cfg.pred_embed_dim, cfg.pred_hidden_size, cfg.pred_layers
        )
        self.joint = JointNetwork(
            cfg.encoder.encoder_embed_dim,
            cfg.pred_hidden_size,
            cfg.joint_dim,
            cfg.vocab_size,
        )

    def encode(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        return self.encoder(src_frames, src_lengths)

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
