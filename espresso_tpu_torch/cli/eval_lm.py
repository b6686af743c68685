"""LM perplexity evaluation (fairseq_cli/eval_lm.py equivalent).

Counterpart of ``espresso_tpu/cli/eval_lm.py``, the recipes' LM stage
(``examples/asr_librispeech/run.sh:61-77``): the token-level perplexity of
the ``dataset.gen_subset`` split (``.bin``/``.idx`` or ``.txt``) under the
LM that the train CLI saved in ``checkpoint.save_dir`` (its
``model_cfg.json`` restores the model section; the weights of
``checkpoint.restore_file``, ``checkpoint_last`` by default), through the
valid step with ``cross_entropy_v2`` on unshuffled batches of at most
``dataset.batch_size`` (32 by default) sentences. Logs ``Evaluated N
tokens: avg nll X, perplexity Y`` and returns ``{"nll_loss", "ppl",
"ntokens"}``.

``main(argv=None, device="cuda")`` runs on the card unless the caller asks
for the CPU.

Usage:
    python -m espresso_tpu_torch.cli.eval_lm dataset.data=DIR \\
        task.name=language_modeling_for_asr checkpoint.save_dir=lm_ckpts \\
        dataset.gen_subset=test
"""

from __future__ import annotations

import logging
import math
import os
import sys
from typing import Dict

import torch

from espresso_tpu_torch.cli.logging_utils import setup_logging
from espresso_tpu_torch.cli.train import put_batch
from espresso_tpu_torch.config import apply_saved_model_cfg, check_single_device, parse_config
from espresso_tpu_torch.tasks import setup_task
from espresso_tpu_torch.train import checkpoint as ckpt
from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_valid_step

logger = logging.getLogger("espresso_tpu_torch.eval_lm")


def main(argv=None, device="cuda") -> Dict[str, float]:
    setup_logging()
    argv = argv if argv is not None else sys.argv[1:]
    cfg = parse_config(argv)
    apply_saved_model_cfg(cfg, argv)
    check_single_device(cfg.distributed)
    cfg.criterion.name = "cross_entropy_v2"
    task = setup_task(cfg)
    ds = task.load_dataset(cfg.dataset.gen_subset)
    model = task.build_model(device=device)
    criterion = task.build_criterion()
    specs = ds.make_batch_specs(
        max_tokens=cfg.dataset.max_tokens,
        max_sentences=cfg.dataset.batch_size or 32,
        shuffle=False,
    )
    optimizer, _ = build_optimizer(cfg)
    state = create_train_state(model, optimizer, cfg)
    path = os.path.join(cfg.checkpoint.save_dir, cfg.checkpoint.restore_file)
    if os.path.exists(path):
        ckpt.restore_weights(state, model, ckpt.load_raw_checkpoint(path))
        logger.info("loaded %s", path)

    valid_step = make_valid_step(model, criterion, cfg)
    sums = []  # per batch, on the device until the pass ends
    for spec in specs:
        stats = valid_step(state, put_batch(ds.collate(spec), device))
        sums.append(torch.stack([stats["nll_loss"].float(), stats["ntokens"].float()]))
    total_nll, total_tokens = 0.0, 0.0
    for nll, ntokens in torch.stack(sums).tolist() if sums else []:
        total_nll += nll
        total_tokens += ntokens
    nll = total_nll / max(total_tokens, 1)
    ppl = math.exp(min(nll, 50))
    logger.info("Evaluated %d tokens: avg nll %.4f, perplexity %.2f", int(total_tokens), nll, ppl)
    return {"nll_loss": nll, "ppl": ppl, "ntokens": total_tokens}


if __name__ == "__main__":
    main()
