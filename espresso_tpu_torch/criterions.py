"""Training criteria.

Counterpart of ``espresso_tpu/criterions.py``, for ``build_criterion``
(criterions.py:402):

* ``transducer_loss``: the flagship's ``TransducerCriterion`` on its fused
  path (criterions.py:171-243), the model's ``forward_fused`` and the
  lattice-free RNNT loss (``ops/rnnt_fused.py``);
* ``cross_entropy_v2`` and ``label_smoothed_cross_entropy_v2``
  (criterions.py:74-130, ``ops/losses.py``) on a speech batch, through the
  encoder-decoder's teacher-forced forward ``model(src_frames,
  src_lengths, prev_output_tokens, ss_prob=)`` (criterions.py:37-60;
  ``ss_prob`` < 1 turns scheduled sampling on), or on a language-model
  batch, one without ``src_frames``, through ``model(prev_output_tokens)``;
* ``ctc_loss``: ``CTCCriterion`` (criterions.py:133-172) on an
  encoder-only model's logits (``models/encoder_models.py``) through
  ``ops/ctc.py``.

A criterion is ``criterion(model, batch) -> (loss, sample_size,
logging)``; the model's train or eval mode decides dropout and batch
statistics. The lattice path (``fused_transducer=False``) and the other
criteria wait for later slices.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from espresso_tpu_torch.config import CriterionSection
from espresso_tpu_torch.ops.ctc import ctc_loss
from espresso_tpu_torch.ops.losses import (
    cross_entropy_loss,
    label_smoothed_cross_entropy,
    unigram_probs_from_counts,
)
from espresso_tpu_torch.ops.rnnt_fused import RnntLossFused
from espresso_tpu_torch.registry import CRITERIONS


def _apply_model(model, batch: Dict[str, torch.Tensor], ss_prob: float = 1.0) -> torch.Tensor:
    """The model's teacher-forced logits. A batch without ``src_frames`` is
    a language-model batch (criterions.py:45-56); scheduled sampling is the
    speech decoder's alone."""
    if "src_frames" not in batch:
        return model(batch["prev_output_tokens"])
    logits, _ = model(
        batch["src_frames"], batch["src_lengths"], batch["prev_output_tokens"], ss_prob=ss_prob
    )
    return logits


class CECriterionBase:
    """Token-level cross entropy over the target's non-pad positions of the
    rows of positive weight; ``sample_size`` is their count, at least 1."""

    logging_keys = ("loss", "nll_loss", "ntokens")

    def __init__(self, cfg: CriterionSection, dictionary):
        self.cfg = cfg
        self.pad = dictionary.pad()
        self.unigram = None
        if cfg.smoothing_type == "unigram":
            self.unigram = torch.from_numpy(
                unigram_probs_from_counts(
                    np.asarray(dictionary.count, dtype=np.float64), cfg.unigram_pseudo_count, self.pad
                )
            )

    def _mask(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return (batch["target"] != self.pad) & (batch["weight"][:, None] > 0)

    def _loss(self, logits, batch, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def __call__(
        self, model, batch: Dict[str, torch.Tensor], ss_prob: float = 1.0
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        logits = _apply_model(model, batch, ss_prob)
        mask = self._mask(batch)
        loss, nll = self._loss(logits, batch, mask)
        ntokens = mask.sum()
        return loss, ntokens.clamp(min=1), {"loss": loss, "nll_loss": nll, "ntokens": ntokens}


@CRITERIONS.register("cross_entropy_v2")
class CrossEntropyV2(CECriterionBase):
    def _loss(self, logits, batch, mask):
        return cross_entropy_loss(logits, batch["target"], mask)


@CRITERIONS.register("label_smoothed_cross_entropy_v2")
class LabelSmoothedCrossEntropyV2(CECriterionBase):
    def _loss(self, logits, batch, mask):
        unigram = None if self.unigram is None else self.unigram.to(logits.device)
        return label_smoothed_cross_entropy(
            logits,
            batch["target"],
            mask,
            self.cfg.label_smoothing,
            smoothing_type=self.cfg.smoothing_type,
            pad_index=self.pad,
            unigram_probs=unigram,
        )


@CRITERIONS.register("ctc_loss")
class CTCCriterion:
    """CTC over an encoder-only model's logits, summed over the batch with
    each utterance's weight. blank = bos; EOS is stripped from the targets
    (to pad) and ``tgt_lengths`` reduced by the count stripped;
    ``sample_size`` is the weighted target tokens, at least 1."""

    logging_keys = ("loss", "ntokens")

    def __init__(self, cfg: CriterionSection, dictionary):
        self.cfg = cfg
        self.pad = dictionary.pad()
        self.eos = dictionary.eos()
        self.blank = dictionary.blank()

    def __call__(
        self, model, batch: Dict[str, torch.Tensor], ss_prob: float = 1.0
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        logits, enc = model(batch["src_frames"], batch["src_lengths"])
        target = batch["target"]
        is_eos = target == self.eos
        target = torch.where(is_eos, self.pad, target)
        tgt_lengths = batch["tgt_lengths"] - is_eos.sum(1).to(batch["tgt_lengths"].dtype)
        losses = ctc_loss(
            logits, enc.src_lengths, target, tgt_lengths, blank=self.blank,
            zero_infinity=self.cfg.zero_infinity,
        )
        weight = batch["weight"]
        loss = (losses * weight).sum()
        ntokens = (tgt_lengths * weight).sum()
        return loss, ntokens.clamp(min=1), {"loss": loss, "ntokens": ntokens}


@CRITERIONS.register("transducer_loss")
class TransducerCriterion:
    """RNNT loss, summed over the batch with each utterance's weight.

    Targets are cut to ``U1 - 1`` columns (``prev_output_tokens`` has U1 =
    U + 1 steps) and ``tgt_lengths`` clipped to ``U1 - 1``; ``sample_size``
    is the number of weighted sentences, at least 1."""

    logging_keys = ("loss", "nsentences")

    def __init__(self, cfg: CriterionSection, dictionary):
        if not cfg.fused_transducer:
            raise NotImplementedError("the lattice transducer criterion (fused_transducer=False)")
        self.cfg = cfg
        self.pad = dictionary.pad()
        self.blank = dictionary.blank()

    def __call__(
        self, model, batch: Dict[str, torch.Tensor], ss_prob: float = 1.0
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, sample_size, logging) for one batch; the model's train or
        eval mode decides dropout and batch statistics. ``ss_prob`` is
        taken and unused, as in JAX."""
        enc_proj, dec_proj, enc = model.forward_fused(
            batch["src_frames"], batch["src_lengths"], batch["prev_output_tokens"]
        )
        U1 = dec_proj.shape[1]
        fc = model.joint.fc_out
        losses = RnntLossFused.apply(
            enc_proj,
            dec_proj,
            fc.weight.t(),
            fc.bias,
            batch["target"][:, : U1 - 1],
            enc.src_lengths,
            batch["tgt_lengths"].clamp(max=U1 - 1),
            self.blank,
        )
        loss = (losses * batch["weight"]).sum()
        nsentences = batch["weight"].sum().clamp(min=1)
        return loss, nsentences, {"loss": loss, "nsentences": nsentences}


def build_criterion(cfg: CriterionSection, task):
    """The criterion ``cfg.name`` names, on the task's dictionary."""
    return CRITERIONS.build(cfg.name, cfg, task.dictionary)
