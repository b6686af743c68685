"""Batched greedy decoding for the attention encoder-decoder.

Counterpart of ``espresso_tpu/decode/greedy.py`` (``SimpleGreedyDecoder``,
:22-98), the valid pass's WER decoder: from an eos-led start, each step
takes the argmax of the f32 log-softmax, a finished row emits pad and adds
nothing to its score, and eos finishes a row. JAX scans all ``max_len =
clamp(int(max_len_a * T + max_len_b), 2, 1024)`` steps, T the batch's
padded frame count; here the loop reads whether every row has finished once
every ``CHECK_EVERY`` steps (one host sync) and stops there, which changes
no hypothesis: a finished row only emits pad. ``decode(batch)`` returns a
list per utterance of one ``{"tokens", "score"}``, tokens up to the first
eos. The speech LSTM steps its carry; the transformer its per-layer caches
(``init_cache`` for ``max_len`` steps, ``decode_step`` at the loop's step
index), as JAX's ``is_transformer`` branch does.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from espresso_tpu_torch.models.speech_lstm import SpeechLSTMModel
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerModel

CHECK_EVERY = 16


def max_decode_len(max_len_a: float, max_len_b: int, T: int) -> int:
    """JAX's output cap: int(a T + b), clamped to [2, 1024]."""
    return max(min(int(max_len_a * T + max_len_b), 1024), 2)


class SimpleGreedyDecoder:
    def __init__(self, model, dictionary, max_len_a: float = 0.0, max_len_b: int = 200):
        if not isinstance(model, (SpeechLSTMModel, SpeechTransformerModel)):
            raise NotImplementedError(
                f"greedy decoding of {type(model).__name__}: only the attention encoder-decoders' "
                "is ported (ROADMAP queue A item 2)"
            )
        self.model = model
        self.eos = dictionary.eos()
        self.pad = dictionary.pad()
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b

    @torch.no_grad()
    def search(self, src_frames: torch.Tensor, src_lengths: torch.Tensor):
        """(tokens [B, <= max_len], scores [B]) on the device."""
        model = self.model
        B = src_frames.shape[0]
        max_len = max_decode_len(self.max_len_a, self.max_len_b, src_frames.shape[1])
        enc = model.encode(src_frames, src_lengths)
        transformer = isinstance(model, SpeechTransformerModel)
        if transformer:
            state = model.init_cache(enc, max_len)
        else:
            state = model.init_decoder_carry(B, dtype=enc.encoder_out.dtype)
        dev = src_frames.device
        tok = torch.full((B,), self.eos, dtype=torch.int32, device=dev)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        score = torch.zeros((B,), dtype=torch.float32, device=dev)
        out = []
        for step in range(max_len):
            if transformer:
                logits, state, _ = model.decode_step(tok, step, state, enc)
            else:
                logits, state, _ = model.decode_step(tok, state, enc)
            lprobs = torch.log_softmax(logits.float(), dim=-1)
            nxt = torch.argmax(lprobs, dim=-1)
            tok_score = lprobs.gather(1, nxt[:, None])[:, 0]
            tok = torch.where(finished, self.pad, nxt).to(torch.int32)
            score = score + torch.where(finished, 0.0, tok_score)
            finished = finished | (tok == self.eos)
            out.append(tok)
            if (step + 1) % CHECK_EVERY == 0 and bool(finished.all()):
                break
        return torch.stack(out, 1), score

    def decode(self, batch: Dict[str, torch.Tensor]) -> List[List[Dict[str, Any]]]:
        """``batch`` holds ``src_frames`` [B, T, F] and ``src_lengths`` [B]
        (tensors or arrays); frames are cast to the model's parameter dtype."""
        param = next(self.model.parameters())
        tokens, scores = self.search(
            torch.as_tensor(batch["src_frames"], device=param.device, dtype=param.dtype),
            torch.as_tensor(batch["src_lengths"], device=param.device),
        )
        tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
        out = []
        for b in range(tokens.shape[0]):
            row = tokens[b]
            eos_pos = np.nonzero(row == self.eos)[0]
            end = int(eos_pos[0]) if len(eos_pos) else len(row)
            out.append([{"tokens": row[:end], "score": float(scores[b])}])
        return out
