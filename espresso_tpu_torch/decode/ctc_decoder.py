"""CTC decoding: greedy (best path) and prefix beam search.

Counterpart of ``espresso_tpu/decode/ctc_decoder.py``: ``CTCGreedyDecoder``
(:18-61) and ``CTCPrefixBeamSearchDecoder`` (:63-187). Both follow the
port's ``decode_async(batch) -> handle`` / ``collect(handle)`` contract:
``decode_async`` launches the device part (the encoder, ``fc_out``, the f32
log-softmax; for greedy also the argmax and the max) and returns without a
host sync; ``collect`` copies its results to the host and runs JAX's host
part, copied as numpy and Python: the collapse of repeats and blanks, or
the prefix search (Hannun et al. 2014) with JAX's dict insertion order, its
stable ``sorted``, its pruning at ``prune_threshold`` (1e-5) and its
``logaddexp``, so that the same log-probs give the same n-best, token for
token and score for score.

JAX's prefix beam search takes ``lm`` and ``lm_weight`` and never reads
them (``_decode_one``, :99-165): an LM changes no hypothesis. The port does
the same.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List

import numpy as np
import torch


def _device_inputs(model, batch: Dict[str, Any]):
    """The batch's frames in the model's parameter dtype and its lengths,
    on the model's device."""
    param = next(model.parameters())
    return (torch.as_tensor(batch["src_frames"], device=param.device, dtype=param.dtype),
            torch.as_tensor(batch["src_lengths"], device=param.device))


@torch.no_grad()
def _log_probs(model, batch: Dict[str, Any]):
    """(f32 log-softmax of the logits [B, T', V], output lengths [B])."""
    logits, enc = model(*_device_inputs(model, batch))
    return torch.log_softmax(logits.float(), dim=-1), enc.src_lengths


def collapse(path: np.ndarray, blank: int) -> np.ndarray:
    """A best path with repeats collapsed and blanks removed (JAX :46-51)."""
    keep = np.ones(len(path), bool)
    keep[1:] = path[1:] != path[:-1]
    collapsed = path[keep]
    return collapsed[collapsed != blank]


class CTCGreedyDecoder:
    def __init__(self, model, dictionary):
        self.model = model
        self.blank = dictionary.blank()
        self.pad = dictionary.pad()

    @torch.no_grad()
    def decode_async(self, batch: Dict[str, Any]):
        lprobs, lengths = _log_probs(self.model, batch)
        best_scores, best = lprobs.max(-1)  # the first maximum, as jnp.argmax
        return best, best_scores, lengths

    def collect(self, handle) -> List[List[Dict[str, Any]]]:
        best, scores, lengths = (x.cpu().numpy() for x in handle)
        results = []
        for b in range(best.shape[0]):
            n = lengths[b]
            tokens = collapse(best[b, :n], self.blank)
            results.append([{"tokens": tokens.astype(np.int32), "score": float(scores[b, :n].sum())}])
        return results

    def decode(self, batch: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        return self.collect(self.decode_async(batch))


class CTCPrefixBeamSearchDecoder:
    """CTC prefix beam search; the device computes the batch's log-probs
    once, the search runs on the host per utterance."""

    def __init__(
        self,
        model,
        dictionary,
        beam_size: int = 10,
        lm=None,
        lm_weight: float = 0.0,
        prune_threshold: float = 1e-5,
    ):
        self.model = model
        self.blank = dictionary.blank()
        self.beam = beam_size
        self.lm = lm  # taken and unread, as in JAX
        self.lm_weight = lm_weight
        self.prune_threshold = prune_threshold

    def _decode_one(self, lp: np.ndarray):
        """lp: [T, V] log-probs -> list of (tokens, score) sorted best-first
        (JAX :99-165, line for line)."""
        NEG = -1.0e30

        def logaddexp(a, b):
            if a <= NEG / 2:
                return b
            if b <= NEG / 2:
                return a
            m = max(a, b)
            return m + np.log(np.exp(a - m) + np.exp(b - m))

        # beams: prefix -> (p_blank, p_nonblank)
        beams = {(): (0.0, NEG)}
        thr = np.log(self.prune_threshold)
        for t in range(lp.shape[0]):
            frame = lp[t]
            cand_tokens = np.nonzero(frame >= thr)[0]
            new_beams = defaultdict(lambda: (NEG, NEG))
            for prefix, (pb, pnb) in beams.items():
                p_total = logaddexp(pb, pnb)
                # extend with blank
                nb_pb, nb_pnb = new_beams[prefix]
                new_beams[prefix] = (logaddexp(nb_pb, p_total + frame[self.blank]), nb_pnb)
                for k in cand_tokens:
                    k = int(k)
                    if k == self.blank:
                        continue
                    pk = float(frame[k])
                    if prefix and prefix[-1] == k:
                        # a repeat extends the non-blank mass of the same
                        # prefix; a new token only after a blank
                        nb_pb2, nb_pnb2 = new_beams[prefix]
                        new_beams[prefix] = (nb_pb2, logaddexp(nb_pnb2, pnb + pk))
                        np_prefix = prefix + (k,)
                        e_pb, e_pnb = new_beams[np_prefix]
                        new_beams[np_prefix] = (e_pb, logaddexp(e_pnb, pb + pk))
                    else:
                        np_prefix = prefix + (k,)
                        e_pb, e_pnb = new_beams[np_prefix]
                        new_beams[np_prefix] = (e_pb, logaddexp(e_pnb, p_total + pk))
            # prune to the beam
            scored = sorted(new_beams.items(), key=lambda kv: -logaddexp(kv[1][0], kv[1][1]))[: self.beam]
            beams = dict(scored)
        out = [(list(prefix), logaddexp(pb, pnb)) for prefix, (pb, pnb) in beams.items()]
        out.sort(key=lambda x: -x[1])
        return out

    @torch.no_grad()
    def decode_async(self, batch: Dict[str, Any]):
        return _log_probs(self.model, batch)

    def collect(self, handle) -> List[List[Dict[str, Any]]]:
        lprobs, lengths = (x.cpu().numpy() for x in handle)
        results = []
        for b in range(lprobs.shape[0]):
            hyps = self._decode_one(lprobs[b, : lengths[b]])
            results.append(
                [{"tokens": np.asarray(toks, np.int32), "score": float(s)} for toks, s in hyps]
                or [{"tokens": np.zeros(0, np.int32), "score": 0.0}]
            )
        return results

    def decode(self, batch: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        return self.collect(self.decode_async(batch))
