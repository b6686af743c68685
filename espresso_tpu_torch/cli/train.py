"""Training entry point (espresso-compatible semantics).

Counterpart of ``espresso_tpu/cli/train.py`` (``main`` :173-483,
``validate`` :65-114, ``_train_loop`` :486-680): the epoch loop over the
task's checkpointable iterator, the train step of ``train/trainer.py`` on
one card, validation at each epoch's end (the valid loss through
``make_valid_step``, WER and CER through the task's greedy valid decoder on
the train state's compute weights; perplexity alone for a task without a
valid decoder, the language model's), the checkpoint policy of
``train/checkpoint.py`` with patience and early stopping, ``max_update``,
mid-epoch ``save_interval_updates``, a SIGTERM handler that saves
``checkpoint_last`` with the iterator's position and exits cleanly (a
restart resumes the state, the iterator, the step generator and ``best``,
so that the run continues bit for bit), a crash checkpoint, the heartbeat
watchdog, ``ema_seed_model``, ``model_cfg.json`` as JAX writes it (an
LM's ``LSTMLMConfig``, which ``speech_recognize``'s ``generation.lm_path``
reads), the epoch-driven lr schedulers (``reduce_lr_on_plateau_v2``,
``manual``: their state in ``host_state["plateau"]``; a new lr reaches the
next update through the schedule, the optimizer's state untouched), and
``common.profile`` (a ``torch.profiler`` trace of the first 5 updates into
``save_dir/profile``), and scheduled sampling (``task.scheduled_sampling``:
each epoch's rate from ``tools/scheduled_sampling.py``, :399-408 and
:523-577). The step's metrics stay on the device and are read once a
``log_interval``.

``main(argv=None, device="cuda")`` runs on the card unless the caller asks
for the CPU (``device="cpu"``, as the tests do). Not ported, and refused:
several devices (``config.check_single_device``, ROADMAP queue A item 3)
and the hybrid task's state prior (item 2).

Usage:
    python -m espresso_tpu_torch.cli.train --config cfg.yaml dataset.data=DIR \\
        model.name=conformer_transducer_librispeech optimization.max_epoch=30
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
from typing import Any, Dict

import numpy as np
import torch

from espresso_tpu_torch.cli.logging_utils import setup_logging
from espresso_tpu_torch.config import check_single_device, config_to_dict, parse_config
from espresso_tpu_torch.tasks import setup_task
from espresso_tpu_torch.tools.scheduled_sampling import ScheduledSamplingRateScheduler
from espresso_tpu_torch.train import checkpoint as ckpt
from espresso_tpu_torch.train.heartbeat import HeartbeatMonitor
from espresso_tpu_torch.train.lr_schedulers import build_epoch_scheduler
from espresso_tpu_torch.train.metrics import MetricsAggregator, ProgressLogger
from espresso_tpu_torch.train.trainer import (
    build_optimizer,
    create_train_state,
    make_device_feature_fn,
    make_train_step,
    make_valid_step,
)

logger = logging.getLogger("espresso_tpu_torch.train")


def put_batch(batch: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """The group's arrays as tensors on ``device`` (the card unless the
    caller asks for the CPU); ``utt_ids`` and the counts (``ntokens``,
    ``nsentences``) stay on the host and are left out, as in the reference.
    On a CUDA device each array is staged in pinned host memory and copied
    with ``non_blocking=True``, so the copies run on the current stream and
    the host goes on (a pageable source would make each copy synchronous)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def _sum_into(acc, metrics: Dict[str, torch.Tensor]):
    """Device-side running sums of the step metrics (no host sync)."""
    if acc is None:
        return {k: v.detach().float().clone() for k, v in metrics.items()}
    for k, v in metrics.items():
        acc[k] += v.detach().float()
    return acc


def validate(cfg, task, model, valid_step, state, valid_itr, device) -> Dict[str, float]:
    """The valid loss (``valid_step``) and, through the task's greedy valid
    decoder on the same weights, WER and CER (reference valid_step
    :598-607). The sums stay on the device until the pass ends."""
    from espresso_tpu_torch.tools.wer import Scorer

    prepare_features = make_device_feature_fn(cfg)
    decoder = task.build_valid_decoder(model)
    scorer = Scorer(task.dictionary, cfg.generation.wer_output_filter)
    dic = task.dictionary
    sums, n = None, 0
    for group in valid_itr:
        dev_group = put_batch(group, device)
        for i in range(group["prev_output_tokens"].shape[0]):
            mb = {k: v[i] for k, v in dev_group.items()}
            sums = _sum_into(sums, valid_step(state, mb))
            n += 1
            if decoder is None:
                continue
            model.eval()
            hypos = decoder.decode(prepare_features(mb))
            utt_ids, weights = group["utt_ids"][i], group["weight"][i]
            target, tgt_lengths = group["target"][i], group["tgt_lengths"][i]
            for b, hyp in enumerate(hypos):
                if weights[b] <= 0:
                    continue
                ref_str = dic.tokens_to_sentence(dic.string(target[b][: tgt_lengths[b]]))
                hyp_str = dic.tokens_to_sentence(dic.string(hyp[0]["tokens"]))
                scorer.add_evaluation(utt_ids[b], ref_str, hyp_str)
    agg = MetricsAggregator()
    if sums is not None:
        agg.update_sums({k: float(v) for k, v in sums.items()}, n)
    stats = agg.smoothed()
    if scorer.tot_word_count() > 0:
        stats["wer"] = scorer.wer()
        stats["cer"] = scorer.cer()
    return stats


# set by the SIGTERM handler; the step loop checks it after each update and
# saves checkpoint_last before a clean exit (preemption-aware save)
_PREEMPT = threading.Event()


def _install_preemption_handler():
    """Route SIGTERM to ``_PREEMPT``; returns the handler it replaced (None
    where none was installed: not the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        return None
    try:
        return signal.signal(signal.SIGTERM, lambda signum, frame: _PREEMPT.set())
    except (ValueError, OSError):
        return None


def write_model_cfg(save_dir: str, model, cfg, model_cfg) -> None:
    """``model_cfg.json``: the resolved model config for decode-time
    reconstruction, as the JAX train CLI writes it."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "model_cfg.json"), "w") as f:
        json.dump(
            {
                "model_name": type(model).__name__,
                "name": cfg.model.get("name"),
                "criterion": cfg.criterion.name,
                "config": config_to_dict(model_cfg),
            },
            f,
            indent=2,
        )


def main(argv=None, device="cuda") -> Dict[str, float]:
    setup_logging()
    _PREEMPT.clear()
    previous_handler = _install_preemption_handler()
    try:
        return _main(argv, device)
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)


def _main(argv, device) -> Dict[str, float]:
    cfg = parse_config(argv if argv is not None else sys.argv[1:])
    check_single_device(cfg.distributed)
    device = torch.device(device)
    np.random.seed(cfg.common.seed)
    torch.manual_seed(cfg.common.seed)

    task = setup_task(cfg)
    train_ds = task.load_dataset(cfg.dataset.train_subset)
    valid_ds = task.load_dataset(cfg.dataset.valid_subset)
    model = task.build_model(device=device)
    criterion = task.build_criterion()
    logger.info("model: %s | criterion: %s", type(model).__name__, cfg.criterion.name)
    write_model_cfg(cfg.checkpoint.save_dir, model, cfg, task.model_cfg)

    if cfg.lr_scheduler.name == "manual" and cfg.lr_scheduler.manual_lr:
        # epoch 1 trains at the first table entry
        cfg.optimization.lr = [float(cfg.lr_scheduler.manual_lr[0])]
    optimizer, schedule = build_optimizer(cfg)
    plateau = build_epoch_scheduler(cfg.lr_scheduler, cfg.optimization)
    train_itr = task.get_batch_iterator(
        train_ds,
        cfg.dataset.max_tokens,
        cfg.dataset.batch_size,
        seed=cfg.common.seed,
        shuffle=True,
        update_freq=cfg.optimization.update_freq[0],
    )
    state = create_train_state(model, optimizer, cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.common.seed)
    logger.info("num params: %s", f"{state.params.numel():,}")

    if cfg.optimization.ema_seed_model and state.ema_params is not None:
        # seed the EMA copy from a checkpoint (reference ema_seed_model ->
        # load_ema_from_checkpoint): its own EMA params, else its params
        raw = ckpt.load_raw_checkpoint(cfg.optimization.ema_seed_model)
        seed = raw.get("ema_params") or raw.get("params")
        if seed is None:
            raise ValueError(f"ema_seed_model {cfg.optimization.ema_seed_model} holds no params")
        with torch.no_grad():
            state.ema_params.copy_(ckpt.flat_params_from_tree(seed, model).to(device))
        logger.info("seeded EMA from %s", cfg.optimization.ema_seed_model)

    ckpt_mgr = ckpt.CheckpointManager(cfg)
    restore = ckpt_mgr.restore_path()
    if restore and not cfg.checkpoint.reset_optimizer:
        tree, host_state = ckpt.load_checkpoint_state(restore)
        ckpt.restore_train_state(state, model, tree, generator)
        logger.info("restored checkpoint from %s", restore)
        if not cfg.checkpoint.reset_dataloader and "iterator" in host_state:
            train_itr.load_state_dict(host_state["iterator"])
        if plateau is not None and "plateau" in host_state:
            plateau.load_state_dict(host_state["plateau"])
            schedule.set_lr(plateau.lr)  # the lr the run had reached
        ckpt_mgr.best = host_state.get("best")

    train_step = make_train_step(model, criterion, optimizer, cfg)
    valid_step = make_valid_step(model, criterion, cfg)
    progress = ProgressLogger(
        cfg.common.log_interval,
        cfg.common.log_format,
        cfg.common.tensorboard_logdir,
        tag="train",
        wandb_project=cfg.common.wandb_project,
        aim_repo=cfg.common.aim_repo,
    )
    hb = HeartbeatMonitor(cfg.distributed.heartbeat_timeout).start()
    try:
        num_updates, final_stats = _train_loop(
            cfg, task, model, train_itr, valid_ds, state, generator, train_step, valid_step,
            schedule, plateau, ckpt_mgr, progress, hb, device,
        )
    except Exception:
        # crash checkpoint (reference trainer.py:858-863 crash.pt)
        if not cfg.checkpoint.no_save:
            ckpt.save_checkpoint_state(
                os.path.join(cfg.checkpoint.save_dir, "checkpoint_crash"),
                ckpt.train_state_arrays(state, model, generator),
                {"iterator": train_itr.state_dict()},
            )
            logger.error("exception — saved checkpoint_crash")
        raise
    finally:
        hb.stop()
        ckpt.wait_for_async_saves()
    logger.info("done training at %d updates", num_updates)
    return final_stats


def _train_loop(cfg, task, model, train_itr, valid_ds, state, generator, train_step, valid_step,
                schedule, plateau, ckpt_mgr, progress, hb, device):
    max_epoch = cfg.optimization.max_epoch or 10**9
    max_update = cfg.optimization.max_update or 10**9
    patience_left = cfg.checkpoint.patience
    num_updates = state.step
    final_stats: Dict[str, float] = {}
    ss_scheduler = (
        ScheduledSamplingRateScheduler(
            cfg.task.scheduled_sampling_probs, cfg.task.start_scheduled_sampling_epoch
        )
        if cfg.task.scheduled_sampling
        else None
    )

    def host_state() -> Dict[str, Any]:
        out: Dict[str, Any] = {"iterator": train_itr.state_dict()}
        if plateau is not None:
            out["plateau"] = plateau.state_dict()
        return out

    def save_last(reason: str) -> None:
        if not cfg.checkpoint.no_save:
            ckpt.save_checkpoint_state(
                os.path.join(cfg.checkpoint.save_dir, "checkpoint_last"),
                ckpt.train_state_arrays(state, model, generator),
                {**host_state(), "best": ckpt_mgr.best},
            )
        logger.info("%s: saved checkpoint_last at %d updates, exiting", reason, num_updates)

    while train_itr.next_epoch_idx <= max_epoch and num_updates < max_update:
        if _PREEMPT.is_set():
            save_last("SIGTERM")
            return num_updates, final_stats
        epoch = train_itr.next_epoch_idx
        epoch_itr = train_itr.next_epoch_itr()
        agg = MetricsAggregator()
        step_args = (ss_scheduler.step(epoch),) if ss_scheduler is not None else ()
        profiler = None
        if cfg.common.profile and epoch == 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        # the metrics stay on the device between log intervals
        sums, n_sums = None, 0

        def flush() -> None:
            nonlocal sums, n_sums
            if sums is not None:
                agg.update_sums({k: float(v) for k, v in sums.items()}, n_sums)
            sums, n_sums = None, 0

        def stop_profiler() -> None:
            nonlocal profiler
            if profiler is not None:
                profiler.stop()
                out = os.path.join(cfg.checkpoint.save_dir, "profile")
                os.makedirs(out, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(out, "trace.json"))
                logger.info("profile trace written to %s", out)
                profiler = None

        for group in epoch_itr:
            state, metrics = train_step(state, put_batch(group, device), generator, *step_args)
            num_updates += 1
            if profiler is not None and num_updates >= 5:
                stop_profiler()
            sums = _sum_into(sums, metrics)
            n_sums += 1
            hb.ping()
            if num_updates % cfg.common.log_interval == 0:
                flush()
                stats = agg.smoothed()
                stats["lr"] = float(schedule(num_updates))
                progress.log(stats, num_updates, epoch)
            if num_updates >= max_update:
                break
            if (
                not cfg.checkpoint.no_save
                and cfg.checkpoint.save_interval_updates > 0
                and num_updates % cfg.checkpoint.save_interval_updates == 0
            ):
                ckpt_mgr.save_epoch(
                    ckpt.train_state_arrays(state, model, generator),
                    host_state(),
                    epoch,
                    end_of_epoch=False,
                    updates=num_updates,
                )
            if _PREEMPT.is_set() and epoch_itr.has_next():
                # preemption-aware save: the iterator's position counts this
                # update's batch, so a restart resumes with the next one
                flush()
                stop_profiler()
                save_last("SIGTERM")
                return num_updates, final_stats

        stop_profiler()
        flush()
        train_stats = agg.smoothed()
        progress.print_epoch(train_stats, epoch)

        valid_itr = task.get_batch_iterator(
            valid_ds, cfg.dataset.max_tokens, cfg.dataset.batch_size, seed=cfg.common.seed,
            shuffle=False,
        ).next_epoch_itr()
        val_stats = validate(cfg, task, model, valid_step, state, valid_itr, device)
        hb.ping()
        ProgressLogger(log_format=cfg.common.log_format, tag="valid").print_epoch(val_stats, epoch)
        val_metric = val_stats.get(cfg.checkpoint.best_checkpoint_metric, val_stats.get("loss"))
        final_stats = {**train_stats, **{f"valid_{k}": v for k, v in val_stats.items()}}

        if plateau is not None:
            old_lr = plateau.lr
            new_lr = plateau.step_epoch(epoch, val_metric)
            if new_lr != old_lr:
                # the next update reads it (JAX re-jits its step, :380-399)
                logger.info("epoch lr scheduler: lr -> %g", new_lr)
                schedule.set_lr(new_lr)

        # checkpoint and early stopping (reference validate_and_save :363-434)
        improved = ckpt_mgr.best is None or (
            val_metric < ckpt_mgr.best
            if not cfg.checkpoint.maximize_best_checkpoint_metric
            else val_metric > ckpt_mgr.best
        )
        if not cfg.checkpoint.no_save:
            ckpt_mgr.save_epoch(
                ckpt.train_state_arrays(state, model, generator),
                host_state(),
                epoch,
                val_metric=val_metric,
            )
        if cfg.checkpoint.patience > 0:
            patience_left = cfg.checkpoint.patience if improved else patience_left - 1
            if patience_left <= 0:
                logger.info("early stop: no improvement in %d epochs", cfg.checkpoint.patience)
                break
    return num_updates, final_stats


if __name__ == "__main__":
    main()
