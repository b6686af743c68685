"""Typed configuration tree with YAML files and dotted overrides.

The port's own copy of the parts of ``espresso_tpu/config.py`` that the
recipe path carries, with the same names and defaults: every section and
field that ``examples/asr_librispeech/conformer_transducer_librispeech.yaml``
names, ``DatasetConfig`` whole, the optimization, optimizer and noam
schedule fields the train and valid steps read, ``CheckpointConfig`` (data
until the checkpoint CLI reads it), the task and criterion names, and the
``model`` section as a dict; ``load_config_dict``, ``parse_config``
(``[--config file.yaml] key.path=value ...``; PyYAML is imported only when
a file is given) and ``config_to_dict``. A key of the reference that the
port does not carry (``distributed``, ``generation``, the other criteria's
and schedules' fields) raises ``KeyError``: ``generation`` comes with the
decode CLIs.

Usage:
    cfg = parse_config(argv)            # --config foo.yaml + dotted overrides
    cfg = load_config_dict({...})       # programmatic
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class CommonConfig:
    seed: int = 1
    log_interval: int = 100
    # numeric precision of the compute path; params are kept fp32
    dtype: str = "bfloat16"  # float32 | bfloat16


@dataclass
class DatasetConfig:
    data: str = ""  # directory with {split}.json manifests + dict
    dict: Optional[str] = None
    non_lang_syms: Optional[str] = None
    train_subset: str = "train"
    valid_subset: str = "valid"
    gen_subset: str = "test"
    max_tokens: Optional[int] = None  # frame budget per batch
    batch_size: Optional[int] = None
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    num_batch_buckets: int = 10  # fixed-shape buckets for XLA (TPU needs this)
    required_batch_size_multiple: int = 8
    skip_invalid_size_inputs_valid_test: bool = False
    # feature extraction
    feat_dim: int = 80
    feature_type: str = "precomputed"  # precomputed | fbank | mfcc | device_fbank | waveform
    sample_rate: int = 16000
    global_cmvn_stats_path: Optional[str] = None
    specaugment_config: Optional[str] = None
    # train-time transforms (fairseq feature/waveform transform registries)
    speed_perturb: Optional[List[float]] = None  # e.g. [0.9, 1.0, 1.1]
    delta_deltas: bool = False  # append d/dd coefficients (3x feat dim)
    noise_augment_path: Optional[str] = None  # dir of noise .wav files
    noise_snr_min: float = 5.0
    noise_snr_max: float = 15.0
    noise_rate: float = 0.25
    # batch on src_len*tgt_len product (transducer memory batching,
    # reference asr_dataset.py:369-382)
    batch_based_on_both_src_tgt: bool = False
    data_buffer_size: int = 4  # prefetch depth
    # parallel host batch materialization (reference fairseq DataLoader
    # workers, fairseq/data/iterators.py:481-532); 0 = in-line + one
    # prefetch thread. Deterministic under workers: every stochastic
    # transform keys on (seed, epoch, utt_index).
    num_workers: int = 0
    worker_backend: str = "process"  # process | thread
    # LM token-block packing over binarized {split}.bin/.idx streams
    # (fairseq TokenBlockDataset: --tokens-per-sample / --sample-break-mode)
    tokens_per_sample: int = 512
    sample_break_mode: str = "none"  # none | complete | eos


@dataclass
class OptimizationConfig:
    max_epoch: int = 0
    max_update: int = 0
    lr: List[float] = field(default_factory=lambda: [0.001])
    clip_norm: float = 0.0
    # microbatches stacked on a batch's leading axis (AsrDataset.group_specs)
    update_freq: List[int] = field(default_factory=lambda: [1])
    # EMA of the fp32 params; 0 = off. Before ema_start_update updates the EMA
    # copies the params; it is touched every ema_update_freq-th update.
    ema_decay: float = 0.0
    ema_start_update: int = 0
    ema_update_freq: int = 1
    # run validation with the EMA weights (train/trainer.py::make_valid_step)
    ema_validate: bool = False
    # quant-noise QAT (fairseq --quant-noise-pq / --quant-noise-pq-block-size)
    quant_noise_pq: float = 0.0
    quant_noise_block_size: int = 8


@dataclass
class CheckpointConfig:
    save_dir: str = "checkpoints"
    restore_file: str = "checkpoint_last"
    save_interval: int = 1  # epochs
    save_interval_updates: int = 0
    keep_last_epochs: int = -1
    keep_best_checkpoints: int = -1
    no_save: bool = False
    no_save_optimizer_state: bool = False
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    patience: int = -1
    reset_dataloader: bool = False
    reset_optimizer: bool = False
    # background checkpoint writes (reference --write-checkpoints-
    # asynchronously, checkpoint_utils.py:549-577): the device->host copy is
    # synchronous, the disk write is not; awaited at train end
    write_checkpoints_asynchronously: bool = False


@dataclass
class OptimizerConfig:
    name: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0


@dataclass
class LRSchedulerConfig:
    name: str = "fixed"
    warmup_updates: int = 0
    warmup_init_lr: float = -1.0
    # noam (espresso/optim/lr_scheduler/noam_lr_scheduler.py:24-70)
    model_size: int = 512
    final_lr: float = 0.0


@dataclass
class TaskSection:
    name: str = "speech_recognition_espresso"


@dataclass
class CriterionSection:
    name: str = "label_smoothed_cross_entropy_v2"
    # the lattice-free fused RNNT loss; only the fused path is ported
    fused_transducer: bool = True


@dataclass
class EspressoConfig:
    """Root config (reference FairseqConfig analogue, configs.py:1194)."""

    common: CommonConfig = field(default_factory=CommonConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    task: TaskSection = field(default_factory=TaskSection)
    criterion: CriterionSection = field(default_factory=CriterionSection)
    # model section is dynamic: chosen by `model.name` / `--arch`
    model: Dict[str, Any] = field(default_factory=lambda: {"name": "speech_lstm"})


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _coerce(value: str) -> Any:
    """Parse a CLI string into bool/int/float/list/str. Bracketed values are
    literal-evaluated (the reference's evaluatable-string convention for conv
    shapes, speech_lstm.py:46-57)."""
    if value[:1] in ("(", "[", "{"):
        import ast

        return ast.literal_eval(value)
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if "," in value:
        return [_coerce(v) for v in value.split(",") if v != ""]
    return value


def _set_dotted(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for part in parts[:-1]:
        if isinstance(obj, dict):
            obj = obj.setdefault(part, {})
        elif hasattr(obj, part):
            obj = getattr(obj, part)
        else:
            raise KeyError(f"unknown config key {dotted!r}")
    last = parts[-1]
    if isinstance(obj, dict):
        obj[last] = value
        return
    if not hasattr(obj, last):
        raise KeyError(f"unknown config key {dotted!r}")
    cur = getattr(obj, last)
    if isinstance(cur, list) and not isinstance(value, list) and value is not None:
        value = [value]
    if isinstance(cur, tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(obj, last, value)


def _merge_dict_into(cfg: Any, data: Dict[str, Any], prefix: str = "") -> None:
    for key, value in data.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and not isinstance(
            getattr(cfg, key, None) if not isinstance(cfg, dict) else cfg.get(key),
            (str, int, float, list),
        ):
            target = (
                cfg.get(key) if isinstance(cfg, dict) else getattr(cfg, key, None)
            )
            if dataclasses.is_dataclass(target) or isinstance(target, dict):
                _merge_dict_into(target, value, prefix=f"{path}.")
                continue
        _set_dotted(cfg, key, value)


def load_config_dict(data: Dict[str, Any]) -> EspressoConfig:
    cfg = EspressoConfig()
    _merge_dict_into(cfg, data)
    return cfg


def parse_config(argv: List[str]) -> EspressoConfig:
    """Parse ``[--config file.yaml] key.path=value ...`` into an EspressoConfig;
    a key the port does not carry raises ``KeyError``."""
    cfg = EspressoConfig()
    overrides: List[Tuple[str, Any]] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--config":
            import yaml

            with open(argv[i + 1]) as f:
                data = yaml.safe_load(f) or {}
            _merge_dict_into(cfg, data)
            i += 2
            continue
        if "=" in arg:
            key, _, value = arg.partition("=")
            key = key.lstrip("-").replace("-", "_")
            overrides.append((key, _coerce(value)))
            i += 1
            continue
        raise ValueError(f"unrecognized argument {arg!r} (use key.path=value)")
    for key, value in overrides:
        _set_dotted(cfg, key, value)
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    return cfg
