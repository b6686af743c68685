"""Training criteria.

Counterpart of ``espresso_tpu/criterions.py``, reduced to the flagship's
``TransducerCriterion`` on its fused path (criterions.py:171-243): the
model's ``forward_fused`` and the lattice-free RNNT loss
(``ops/rnnt_fused.py``), registered as ``transducer_loss`` for
``build_criterion`` (criterions.py:402). The lattice path
(``fused_transducer=False``) and the other criteria wait for later slices.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from espresso_tpu_torch.config import CriterionSection
from espresso_tpu_torch.ops.rnnt_fused import RnntLossFused
from espresso_tpu_torch.registry import CRITERIONS


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
        self, model, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, sample_size, logging) for one batch; the model's train or
        eval mode decides dropout and batch statistics."""
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
