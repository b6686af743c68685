"""Batched transducer greedy decoding.

Counterpart of ``espresso_tpu/decode/transducer_greedy.py``
(transducer_greedy.py:19-169): a batched greedy lattice walk with at most
``max_num_expansions_per_step`` label expansions per encoder frame. The JAX
frame ``lax.scan`` becomes a Python loop over encoder frames with the
expansion loop unrolled inside; every step stays on the device, and the
result is packed into one int32 tensor so ``collect`` makes one host
transfer. (A CUDA graph of the frame step is later work.)
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


class TransducerGreedyDecoder:
    def __init__(
        self,
        model,
        dictionary,
        max_num_expansions_per_step: int = 2,
        max_out_factor: float = 1.0,
        model_predicts_eos: bool = False,
    ):
        self.model = model
        self.dict = dictionary
        self.blank = dictionary.blank()
        self.eos = dictionary.eos()
        self.max_expansions = max_num_expansions_per_step
        self.max_out_factor = max_out_factor
        self.model_predicts_eos = model_predicts_eos

    @torch.no_grad()
    def _run(
        self, src_frames: torch.Tensor, src_lengths: torch.Tensor, L_max: int
    ) -> torch.Tensor:
        model, blank, eos = self.model, self.blank, self.eos
        B, dev = src_frames.shape[0], src_frames.device
        enc = model.encode(src_frames, src_lengths)
        pdtype = next(model.parameters()).dtype
        carry = model.init_pred_carry(B, pdtype, dev)
        # prediction feature for the initial (blank-history) state: feed
        # blank once (the reference starts from bos/blank history)
        feat, carry = model.pred_step(
            torch.full((B,), blank, dtype=torch.long, device=dev), carry
        )
        out_buf = torch.zeros(B, L_max, dtype=torch.int32, device=dev)
        out_len = torch.zeros(B, dtype=torch.int32, device=dev)
        score = torch.zeros(B, dtype=torch.float32, device=dev)
        rows = torch.arange(B, device=dev)
        # precompute the joint's encoder projection for all frames
        enc_proj = model.joint_enc_proj(enc.encoder_out)
        for t in range(enc_proj.shape[1]):
            enc_t = enc_proj[:, t]
            expanding = t < enc.src_lengths
            for _ in range(self.max_expansions):
                logits = model.joint_step_precomputed(enc_t, feat)
                lprobs = torch.log_softmax(logits.float(), dim=-1)
                if self.model_predicts_eos:
                    # fold eos mass into blank to mitigate deletion errors
                    lprobs[:, blank] = torch.logaddexp(lprobs[:, blank], lprobs[:, eos])
                    lprobs[:, eos] = -float("inf")
                k = torch.argmax(lprobs, dim=-1)  # first index on ties
                k_score = lprobs.gather(1, k[:, None])[:, 0]
                emit = (k != blank) & expanding & (out_len < L_max)
                slot = out_len.clamp(max=L_max - 1)
                out_buf[rows, slot] = torch.where(emit, k.int(), out_buf[rows, slot])
                out_len += emit.int()
                score += torch.where(expanding, k_score, 0.0)
                # advance the predictor for emitting rows
                new_feat, new_carry = model.pred_step(k, carry)
                feat = torch.where(emit[:, None], new_feat, feat)
                carry = tuple(
                    torch.where(emit[None, :, None], n, o)
                    for n, o in zip(new_carry, carry)
                )
                expanding = emit
        # one int32 array [B, 2 + L_max]: score bits, length, tokens
        return torch.cat([score.view(torch.int32)[:, None], out_len[:, None], out_buf], 1)

    def decode_async(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Launch the greedy search on the model's device; the host fetch is
        deferred to ``collect``. ``batch`` holds ``src_frames`` [B, T, F] and
        ``src_lengths`` [B] (tensors or arrays); frames are cast to the
        model's parameter dtype."""
        param = next(self.model.parameters())
        src_frames = torch.as_tensor(
            batch["src_frames"], device=param.device, dtype=param.dtype
        )
        src_lengths = torch.as_tensor(batch["src_lengths"], device=param.device)
        T = src_frames.shape[1]
        L_max = max(int(T * self.max_out_factor), 8)
        return self._run(src_frames, src_lengths, L_max)

    def collect(self, handle: torch.Tensor) -> List[List[Dict[str, Any]]]:
        packed = handle.cpu().numpy()
        score = np.ascontiguousarray(packed[:, 0]).view(np.float32)
        out_len = packed[:, 1]
        out_buf = packed[:, 2:]
        return [
            [
                {
                    "tokens": out_buf[b, : out_len[b]].astype(np.int32),
                    "score": float(score[b]),
                }
            ]
            for b in range(out_buf.shape[0])
        ]

    def decode(self, batch: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        return self.collect(self.decode_async(batch))
