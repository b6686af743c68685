"""Recognition entry point (espresso-compatible outputs).

Counterpart of ``espresso_tpu/cli/speech_recognize.py``: loads a port
checkpoint (``train/checkpoint.py``; its ``params`` tree loads through
``bridge.load_jax_variables``), decodes a split with the task's generator
(for the transducer greedy at a beam of at most 1, else the AES beam
search; for the attention encoder-decoder the beam search of
``decode/beam_search.py``; each fused with an LSTM LM from
``generation.lm_path``; for a CTC model its greedy decoder at a beam of at
most 1, else the prefix beam search of ``decode/ctc_decoder.py``, which
takes the LM unread, as JAX's does), and writes ``decoded_results.txt``,
``wer``, ``cer`` and ``aligned_results.txt`` as JAX writes them, with the
"Recognized N utterances" throughput line. The decode is pipelined one
deep: the next batch's search is launched (``decode_async``) before the
previous one is collected and scored on the host. Each batch goes through
the feature front first (``make_device_feature_fn``: a PCM batch becomes
log-mel frames on the device). Transducers have no ``decode_sequence``, so
``generation.print_alignment`` writes nothing for them, as in JAX; for the
attention encoder-decoder it raises: JAX writes the attention matrices and
their plots there (:204-233, :327-339), and ``tools/plot`` is not ported
(ROADMAP queue A item 3).

``main(argv=None, device="cuda")`` runs on the card unless the caller asks
for the CPU. A word LM (``generation.word_lm_path``, the look-ahead LM) is
not ported (ROADMAP queue A item 2).

Usage:
    python -m espresso_tpu_torch.cli.speech_recognize --config cfg.yaml \\
        dataset.data=DIR dataset.gen_subset=test generation.beam=10 \\
        checkpoint.save_dir=ckpts [generation.lm_path=... generation.lm_weight=0.47]
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from espresso_tpu_torch.bridge import load_jax_variables
from espresso_tpu_torch.cli.logging_utils import setup_logging
from espresso_tpu_torch.cli.train import put_batch
from espresso_tpu_torch.config import (
    EspressoConfig,
    apply_saved_model_cfg,
    check_single_device,
    parse_config,
)
from espresso_tpu_torch.tasks import setup_task
from espresso_tpu_torch.tools.wer import Scorer
from espresso_tpu_torch.train.checkpoint import load_raw_checkpoint
from espresso_tpu_torch.train.trainer import make_device_feature_fn

logger = logging.getLogger("espresso_tpu_torch.recognize")


def _decode_dtype(cfg: EspressoConfig):
    return torch.bfloat16 if cfg.common.dtype == "bfloat16" else torch.float32


def load_model_for_decoding(cfg: EspressoConfig, task, device="cuda"):
    """The task's model with the checkpoint's ``params`` and
    ``batch_stats`` (``checkpoint.save_dir / checkpoint.restore_file``), in
    eval mode on ``device``; cast whole to bf16 when ``common.dtype`` is
    bfloat16 (batch-norm statistics included: the decoders run a model cast
    whole)."""
    model = task.build_model(device=device)
    path = os.path.join(cfg.checkpoint.save_dir, cfg.checkpoint.restore_file)
    if os.path.exists(path):
        raw = load_raw_checkpoint(path)
        load_jax_variables(model, {"params": raw["params"], "batch_stats": raw.get("batch_stats") or {}})
        logger.info("loaded checkpoint %s", path)
    else:
        logger.warning("no checkpoint at %s — decoding with random init", path)
    return model.to(_decode_dtype(cfg)).eval()


def _load_lm_checkpoint(ckpt_dir: str, device, dtype):
    """An LSTM LM trained by this framework: a checkpoint directory with
    ``model_cfg.json`` (written by the train CLI) and ``checkpoint_last``."""
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig

    with open(os.path.join(ckpt_dir, "model_cfg.json")) as f:
        blob = json.load(f)
    cfg_kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in blob["config"].items()}
    lm_cfg = LSTMLMConfig(**cfg_kwargs)
    lm = LSTMLanguageModel(lm_cfg).to(device)
    raw = load_raw_checkpoint(os.path.join(ckpt_dir, "checkpoint_last"))
    load_jax_variables(lm, {"params": raw["params"]})
    return lm.to(dtype).eval(), lm_cfg


def build_lm(cfg: EspressoConfig, task, device="cuda"):
    """LM fusion wiring (reference speech_recognize.py:111-166): a subword
    LSTM LM from ``generation.lm_path`` is fused by shallow fusion inside the
    beam search; None without one."""
    gen = cfg.generation
    if gen.word_lm_path:
        raise NotImplementedError(
            "generation.word_lm_path: the look-ahead word LM (and the multi-level LM) is not "
            "ported (ROADMAP queue A item 2)"
        )
    if gen.lm_path:
        return _load_lm_checkpoint(gen.lm_path, device, _decode_dtype(cfg))[0]
    return None


def main(argv=None, device="cuda") -> Dict[str, float]:
    setup_logging()
    argv = argv if argv is not None else sys.argv[1:]
    cfg = parse_config(argv)
    apply_saved_model_cfg(cfg, argv)
    check_single_device(cfg.distributed)
    task = setup_task(cfg)
    ds = task.load_dataset(cfg.dataset.gen_subset)
    model = load_model_for_decoding(cfg, task, device)
    if cfg.generation.print_alignment and hasattr(model, "decode_sequence"):
        raise NotImplementedError(
            "generation.print_alignment: the attention matrices and their plots need tools/plot, "
            "which is not ported (ROADMAP queue A item 3)"
        )
    lm = build_lm(cfg, task, device)
    generator = task.build_generator(model, cfg.generation, lm=lm, lm_weight=cfg.generation.lm_weight)

    itr = task.get_batch_iterator(
        ds, cfg.dataset.max_tokens, cfg.dataset.batch_size or 8, shuffle=False
    ).next_epoch_itr()
    prepare_features = make_device_feature_fn(cfg)
    scorer = Scorer(task.dictionary, cfg.generation.wer_output_filter)
    dic = task.dictionary

    num_utts = num_tokens = 0
    has_ref = False

    def consume(item):
        nonlocal num_utts, num_tokens, has_ref
        handle, mb, utt_ids = item
        hypos = generator.collect(handle)
        for b, hyp_list in enumerate(hypos):
            if mb["weight"][b] <= 0:
                continue
            num_utts += 1
            best = hyp_list[0]
            num_tokens += len(best["tokens"])
            hyp_str = dic.tokens_to_sentence(dic.string(best["tokens"]))
            scorer.add_prediction(utt_ids[b], hyp_str)
            if mb["tgt_lengths"][b] > 0:
                has_ref = True
                tgt = mb["target"][b][: mb["tgt_lengths"][b]]
                ref_str = dic.tokens_to_sentence(dic.string(tgt, extra_symbols_to_ignore={dic.pad()}))
                scorer.add_evaluation(utt_ids[b], ref_str, hyp_str)

    # depth-1 pipeline: launch the next batch's search before collecting the
    # previous one (its host transfer and the WER bookkeeping overlap it)
    t0 = time.perf_counter()
    pending = None
    for group in itr:
        dev_group = put_batch(group, device)
        for i in range(group["prev_output_tokens"].shape[0]):
            mb = {k: v[i] for k, v in group.items() if isinstance(v, np.ndarray)}
            dec_mb = prepare_features({k: v[i] for k, v in dev_group.items()})
            handle = generator.decode_async(dec_mb)
            if pending is not None:
                consume(pending)
            pending = (handle, mb, group["utt_ids"][i])
    if pending is not None:
        consume(pending)
    elapsed = time.perf_counter() - t0
    logger.info(
        "Recognized %d utterances in %.1fs (%.2f sentences/s, %.2f tokens/s)",
        num_utts,
        elapsed,
        num_utts / max(elapsed, 1e-6),
        num_tokens / max(elapsed, 1e-6),
    )

    results: Dict[str, float] = {"num_utts": num_utts}
    out_dir = cfg.generation.results_path or cfg.checkpoint.save_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "decoded_results.txt"), "w") as f:
        f.write(scorer.results)
    if has_ref:
        results["wer"] = scorer.wer()
        results["cer"] = scorer.cer()
        with open(os.path.join(out_dir, "wer"), "w") as f:
            f.write(f"WER: {scorer.wer():.2f}%, {scorer.tot_word_error()} / {scorer.tot_word_count()}\n")
        with open(os.path.join(out_dir, "cer"), "w") as f:
            f.write(f"CER: {scorer.cer():.2f}%, {scorer.tot_char_error()} / {scorer.tot_char_count()}\n")
        with open(os.path.join(out_dir, "aligned_results.txt"), "w") as f:
            f.write(scorer.aligned_results)
        logger.info("WER: %.2f%%  CER: %.2f%%", scorer.wer(), scorer.cer())
    return results


if __name__ == "__main__":
    main()
