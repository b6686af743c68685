"""Batched beam search for the attention encoder-decoder, with LSTM-LM
shallow fusion.

Counterpart of ``espresso_tpu/decode/beam_search.py`` (``BeamSearchDecoder``,
:32-646), step for step:

* all B utterances x K beams advance in one [B*K] decoder step, from an
  eos-led prefix with only beam 0 of each utterance live;
* the step's f32 log-probs (``log_softmax(logits / temperature)``) get
  ``lm_weight`` times the LM's (a narrower LM vocab padded with
  ``NEG_INF``); pad is banned, eos before ``min_len`` steps, eos where its
  log-prob falls under ``eos_factor`` times the best other token's, and
  every token but the prefix's while a prefix lasts;
* the 2K best of [B, K*V] continuations are taken, the eos ones finalised
  into fixed [B, K] buffers (score / length ** lenpen, best K kept), the
  best K others continue; the decoder's and the LM's states are reordered
  by a gather;
* ``max_len = clamp(int(max_len_a * T + max_len_b), 2, 1024)`` steps, T the
  batch's padded frame count, as JAX counts it; an utterance with nothing
  finalised falls back to its live beams.

Every selection is a stable descending sort, so ties go to the lower index
as ``jax.lax.top_k`` gives them. The loop makes no host sync: it runs all
``max_len`` steps, as JAX's scan does. ``decode_async(batch)`` launches the
search and returns its tensors on the device; ``collect`` turns them into
a list per utterance of K ``{"tokens", "score"}``, best first, tokens
without the leading eos, pads and a final eos.

Not ported, and refused with ``NotImplementedError`` (ROADMAP queue A item
1): sampling, diverse beam groups, ``no_repeat_ngram_size``, lexical
constraints and model ensembles.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from espresso_tpu_torch.decode.api import make_adapter, repeat_encoder_out
from espresso_tpu_torch.decode.greedy import max_decode_len

NEG_INF = -1.0e9


def _refuse(what: str) -> None:
    raise NotImplementedError(f"beam search {what} is not ported (ROADMAP queue A item 1)")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _pow_f32(base: int, exponent: float) -> float:
    """base ** exponent in f32, floored at 1e-6 (JAX's length norm)."""
    return max(float(np.float32(base) ** np.float32(exponent)), 1e-6)


class BeamSearchDecoder:
    def __init__(
        self,
        model,
        dictionary,
        beam_size: int = 5,
        max_len_a: float = 0.0,
        max_len_b: int = 200,
        min_len: int = 1,
        len_penalty: float = 1.0,
        eos_factor: Optional[float] = None,
        temperature: float = 1.0,
        lm=None,
        lm_weight: float = 0.0,
        sampling: bool = False,
        no_repeat_ngram_size: int = 0,
        diverse_beam_groups: int = 1,
    ):
        if isinstance(model, (list, tuple)):
            _refuse("over a model ensemble")
        if sampling:
            _refuse("sampling")
        if diverse_beam_groups > 1:
            _refuse("with diverse beam groups")
        if no_repeat_ngram_size > 0:
            _refuse("with no_repeat_ngram_size")
        self.model = model
        self.adapter = make_adapter(model)
        self.lm_adapter = None if lm is None else make_adapter(lm)
        self.lm_weight = lm_weight
        self.beam = beam_size
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.len_penalty = len_penalty
        self.eos_factor = eos_factor
        self.temperature = temperature
        self.eos = dictionary.eos()
        self.pad = dictionary.pad()

    @torch.no_grad()
    def search(
        self,
        src_frames: torch.Tensor,
        src_lengths: torch.Tensor,
        prefix_tokens: Optional[torch.Tensor] = None,
    ):
        """(fin_tokens [B, K, max_len + 1], fin_scores [B, K], fin_raw [B,
        K], fin_lens [B, K]) on the device."""
        K, eos, pad = self.beam, self.eos, self.pad
        adapter, lm_adapter = self.adapter, self.lm_adapter
        use_lm = lm_adapter is not None and self.lm_weight != 0.0
        B = src_frames.shape[0]
        BK = B * K
        dev = src_frames.device
        max_len = max_decode_len(self.max_len_a, self.max_len_b, src_frames.shape[1])
        enc = repeat_encoder_out(self.model.encode(src_frames, src_lengths), K)
        state = adapter.init_state(enc, BK, max_len)
        lm_state = lm_adapter.init_state(None, BK, max_len) if lm_adapter is not None else None
        pref_len = 0 if prefix_tokens is None else prefix_tokens.shape[1]
        if pref_len > 0:
            prefix_tokens = prefix_tokens.to(device=dev, dtype=torch.int64)
            pref_lens = (prefix_tokens != pad).sum(1)

        tokens = torch.full((B, K, max_len + 1), pad, dtype=torch.int64, device=dev)
        tokens[:, :, 0] = eos
        scores = torch.full((B, K), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        fin_tokens = torch.full_like(tokens, pad)
        fin_scores = torch.full((B, K), NEG_INF, device=dev)
        fin_raw = torch.full((B, K), NEG_INF, device=dev)
        fin_lens = torch.zeros((B, K), dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)[:, None] * K
        neg = torch.full((), NEG_INF, device=dev)

        for step in range(max_len):
            cur_tok = tokens.view(BK, -1)[:, step]
            logits, state, _ = adapter.step(cur_tok, state, enc, step)
            lprobs = torch.log_softmax(logits.float() / self.temperature, dim=-1)
            V = lprobs.shape[-1]
            if use_lm:
                lm_logits, lm_state, _ = lm_adapter.step(cur_tok, lm_state)
                lm_lp = torch.log_softmax(lm_logits.float(), dim=-1)
                if lm_lp.shape[-1] < V:
                    lm_lp = torch.nn.functional.pad(lm_lp, (0, V - lm_lp.shape[-1]), value=NEG_INF)
                lprobs = lprobs + self.lm_weight * lm_lp[:, :V]
            lprobs[:, pad] = NEG_INF
            if step < self.min_len:
                lprobs[:, eos] = NEG_INF
            if self.eos_factor is not None:
                eos_lp = lprobs[:, eos].clone()
                lprobs[:, eos] = NEG_INF
                allow = eos_lp >= self.eos_factor * lprobs.max(dim=-1).values
                lprobs[:, eos] = torch.where(allow, eos_lp, neg)
            if pref_len > 0:
                in_pref = (step < pref_lens).repeat_interleave(K)
                forced = prefix_tokens[:, min(step, pref_len - 1)].repeat_interleave(K)
                not_forced = torch.arange(V, device=dev)[None, :] != forced[:, None]
                lprobs = torch.where(in_pref[:, None] & not_forced, neg, lprobs)

            cand = (scores.reshape(BK, 1) + lprobs).view(B, K * V)
            top_scores, top_idx = top_k(cand, 2 * K)
            beam_idx = torch.div(top_idx, V, rounding_mode="floor")
            tok_idx = top_idx % V
            is_eos = tok_idx == eos

            # finalise the eos candidates
            new_len = step + 1
            norm = top_scores / _pow_f32(new_len, self.len_penalty)
            cand_tokens = tokens.view(BK, -1)[(rows + beam_idx).reshape(-1)].view(B, 2 * K, -1)
            cand_tokens[:, :, step + 1] = tok_idx
            all_scores = torch.cat([fin_scores, torch.where(is_eos, norm, neg)], 1)
            all_raw = torch.cat([fin_raw, torch.where(is_eos, top_scores, neg)], 1)
            all_tokens = torch.cat([fin_tokens, cand_tokens], 1)
            all_lens = torch.cat([fin_lens, torch.full_like(tok_idx, new_len)], 1)
            fin_scores, keep = top_k(all_scores, K)
            fin_tokens = all_tokens.gather(1, keep[:, :, None].expand(-1, -1, all_tokens.shape[2]))
            fin_raw = all_raw.gather(1, keep)
            fin_lens = all_lens.gather(1, keep)

            # continue with the best K others
            scores, sel = top_k(torch.where(is_eos, neg, top_scores), K)
            flat_sel = (rows + beam_idx.gather(1, sel)).reshape(-1)
            tokens = tokens.view(BK, -1)[flat_sel].view(B, K, -1)
            tokens[:, :, step + 1] = tok_idx.gather(1, sel)
            state = adapter.reorder(state, flat_sel)
            if lm_state is not None:
                lm_state = lm_adapter.reorder(lm_state, flat_sel)

        # an utterance with nothing finalised keeps its live beams
        no_fin = fin_scores[:, 0] <= NEG_INF / 2
        unfin = scores / _pow_f32(max_len, self.len_penalty)
        fin_scores = torch.where(no_fin[:, None], unfin, fin_scores)
        fin_tokens = torch.where(no_fin[:, None, None], tokens, fin_tokens)
        fin_lens = torch.where(no_fin[:, None], torch.full_like(fin_lens, max_len + 1), fin_lens)
        return fin_tokens, fin_scores, fin_raw, fin_lens

    def decode_async(self, batch: Dict[str, torch.Tensor], prefix_tokens=None, constraints=None):
        """Launch the search; returns its tensors on the device. ``batch``
        holds ``src_frames`` [B, T, F] and ``src_lengths`` [B] (tensors or
        arrays); frames are cast to the model's parameter dtype.
        ``prefix_tokens`` [B, P] (pad-padded) forces each hypothesis through
        its prefix."""
        if constraints is not None:
            _refuse("with lexical constraints")
        param = next(self.model.parameters())
        return self.search(
            torch.as_tensor(batch["src_frames"], device=param.device, dtype=param.dtype),
            torch.as_tensor(batch["src_lengths"], device=param.device),
            None if prefix_tokens is None else torch.as_tensor(prefix_tokens, device=param.device),
        )

    def collect(self, handle) -> List[List[Dict[str, Any]]]:
        fin_tokens, fin_scores, _, fin_lens = (x.cpu().numpy() for x in handle)
        results = []
        for b in range(fin_tokens.shape[0]):
            hypos = []
            for k in range(fin_tokens.shape[1]):
                L = int(fin_lens[b, k])
                toks = fin_tokens[b, k, 1 : L + 1]
                toks = toks[toks != self.pad]
                if len(toks) and toks[-1] == self.eos:
                    toks = toks[:-1]
                hypos.append({"tokens": toks.astype(np.int32), "score": float(fin_scores[b, k])})
            results.append(hypos)
        return results

    def decode(self, batch, prefix_tokens=None, constraints=None) -> List[List[Dict[str, Any]]]:
        return self.collect(self.decode_async(batch, prefix_tokens, constraints))
