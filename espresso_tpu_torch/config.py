"""Typed configuration tree with YAML files and dotted overrides.

The port's own copy of the parts of ``espresso_tpu/config.py`` that the
recipe path carries, with the same names and defaults: every section and
field that ``examples/asr_librispeech/conformer_transducer_librispeech.yaml``
names, ``DatasetConfig``, ``DistributedConfig`` and ``GenerationConfig``
whole, the ``common`` fields the CLIs read (logging sinks, ``profile``),
the optimization, optimizer and noam schedule fields the train and valid
steps read, ``CheckpointConfig``, the task and criterion names, and the
``model`` section as a dict; ``load_config_dict``, ``parse_config``
(``[--config file.yaml] key.path=value ...``; PyYAML is imported only for
a YAML file, a ``.json`` file is read without it; every key set is
recorded in ``cfg._explicit_keys``),
``apply_saved_model_cfg`` and ``config_to_dict``. A key of the reference
that the port does not carry (the other criteria's and schedules' fields)
raises ``KeyError``; a ``distributed`` setting that asks for more than one
device raises ``NotImplementedError`` in ``check_single_device``.

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
    log_format: str = "simple"  # simple | json
    tensorboard_logdir: Optional[str] = None
    wandb_project: Optional[str] = None  # reference --wandb-project
    aim_repo: Optional[str] = None  # reference --aim-repo
    # numeric precision of the compute path; params are kept fp32
    dtype: str = "bfloat16"  # float32 | bfloat16
    profile: bool = False  # torch.profiler trace of the first training updates


@dataclass
class DistributedConfig:
    """The reference's fields that choose the devices, with its defaults (the
    port runs on one card: ``check_single_device``; the bmuf and slowmo
    knobs are not carried), and the heartbeat."""

    data_parallel_size: int = -1
    model_parallel_size: int = 1
    fsdp: bool = False
    pipeline_parallel_size: int = 1
    sequence_parallel: bool = False
    ddp_backend: str = "ddp"  # ddp | bmuf | slowmo
    # kill the job if no training progress for this many seconds (reference
    # DistributedTimeoutWrapper / --heartbeat-timeout); <= 0 disables
    heartbeat_timeout: int = -1
    coordinator_address: Optional[str] = None
    num_processes: int = 1


def check_single_device(dcfg: DistributedConfig) -> None:
    """Raise ``NotImplementedError`` where ``dcfg`` asks for more than one
    device: meshes, FSDP, pipeline and sequence parallelism, bmuf/slowmo,
    several processes (ROADMAP queue A item 6)."""
    asks = [
        (dcfg.data_parallel_size not in (-1, 1), f"data_parallel_size={dcfg.data_parallel_size}"),
        (dcfg.model_parallel_size > 1, f"model_parallel_size={dcfg.model_parallel_size}"),
        (dcfg.fsdp, "fsdp"),
        (dcfg.pipeline_parallel_size > 1, f"pipeline_parallel_size={dcfg.pipeline_parallel_size}"),
        (dcfg.sequence_parallel, "sequence_parallel"),
        (dcfg.ddp_backend != "ddp", f"ddp_backend={dcfg.ddp_backend!r}"),
        (dcfg.num_processes > 1 or dcfg.coordinator_address is not None, "several processes"),
    ]
    what = [w for bad, w in asks if bad]
    if what:
        raise NotImplementedError(
            f"distributed {', '.join(what)}: the port runs on one card; meshes, bmuf/slowmo, "
            "pipeline and sequence parallelism are not ported (ROADMAP queue A item 6)"
        )


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
    # seed the EMA copy from a checkpoint (reference ema_seed_model)
    ema_seed_model: Optional[str] = None
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
class GenerationConfig:
    beam: int = 1
    nbest: int = 1  # hypotheses to report per utterance (interactive CLI)
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    lenpen: float = 1.0
    temperature: float = 1.0
    # espresso decode extras (speech_recognize.py)
    eos_factor: Optional[float] = None
    lm_weight: float = 0.0
    lm_path: Optional[str] = None
    word_lm_path: Optional[str] = None
    subwordlm_weight: float = 0.8
    oov_penalty: float = 1e-4
    open_vocab: bool = True
    # transducer beam search (adaptive expansion search)
    expansion_beta: int = 0
    expansion_gamma: Optional[float] = None
    max_num_expansions_per_step: int = 2
    prefix_alpha: Optional[int] = None
    model_predicts_eos: bool = False
    # output-length cap as a fraction of input frames (transducer decoders)
    max_out_factor: float = 0.35
    # fairseq sequence_generator extras
    no_repeat_ngram_size: int = 0
    sampling: bool = False
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    diverse_beam_groups: int = 1
    diverse_beam_strength: float = 0.5
    print_alignment: bool = False
    results_path: Optional[str] = None
    wer_output_filter: Optional[str] = None


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
    # scheduled sampling is not ported (ROADMAP queue A item 4): the train
    # CLI refuses it
    scheduled_sampling: bool = False


@dataclass
class CriterionSection:
    name: str = "label_smoothed_cross_entropy_v2"
    # the lattice-free fused RNNT loss; only the fused path is ported
    fused_transducer: bool = True


@dataclass
class EspressoConfig:
    """Root config (reference FairseqConfig analogue, configs.py:1194)."""

    common: CommonConfig = field(default_factory=CommonConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
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


def _flatten_keys(data: Dict[str, Any], prefix: str = "") -> List[str]:
    keys = []
    for k, v in data.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) and v:
            keys.extend(_flatten_keys(v, prefix=f"{path}."))
        else:
            keys.append(path)
    return keys


def parse_config(argv: List[str]) -> EspressoConfig:
    """Parse ``[--config file.yaml] key.path=value ...`` into an EspressoConfig;
    a key the port does not carry raises ``KeyError``. Every key the user
    set, in the file or in argv, is recorded in ``cfg._explicit_keys``, so
    that ``apply_saved_model_cfg`` tells a deliberate value from a default."""
    cfg = EspressoConfig()
    explicit: set = set()
    overrides: List[Tuple[str, Any]] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--config":
            with open(argv[i + 1]) as f:
                if argv[i + 1].endswith(".json"):  # JSON is YAML; no PyYAML needed
                    import json

                    data = json.load(f)
                else:
                    import yaml

                    data = yaml.safe_load(f) or {}
            _merge_dict_into(cfg, data)
            explicit.update(_flatten_keys(data))
            i += 2
            continue
        if "=" in arg:
            key, _, value = arg.partition("=")
            key = key.lstrip("-").replace("-", "_")
            overrides.append((key, _coerce(value)))
            explicit.add(key)
            i += 1
            continue
        raise ValueError(f"unrecognized argument {arg!r} (use key.path=value)")
    for key, value in overrides:
        _set_dotted(cfg, key, value)
    cfg._explicit_keys = explicit
    return cfg


def apply_saved_model_cfg(cfg, argv: Optional[List[str]] = None):
    """Decode-time model reconstruction (the reference's saved-cfg restore):
    when ``checkpoint.save_dir`` holds a ``model_cfg.json`` written by the
    train CLI, the resolved model section saved there becomes ``cfg.model``,
    so a decode command need not repeat every ``model.*`` flag; the
    ``model.*`` values the user set still win, and the saved criterion is
    restored unless ``criterion.name`` was set."""
    import json
    import os

    path = os.path.join(cfg.checkpoint.save_dir, "model_cfg.json")
    if not os.path.exists(path):
        return cfg
    with open(path) as f:
        blob = json.load(f)
    if "name" not in blob:  # written before the section name was recorded
        return cfg
    saved_cfg: Dict[str, Any] = dict(blob.get("config") or {})
    saved_cfg.pop("name", None)  # keep the recorded arch name authoritative
    section: Dict[str, Any] = {"name": blob["name"], **saved_cfg}

    # overlay every model override the user supplied (the file and argv
    # both land in cfg.model); the default sentinel name is not an override
    def overlay(dst: Dict[str, Any], src: Dict[str, Any]):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                overlay(dst[k], v)
            else:
                dst[k] = v

    def set_by_user(key: str) -> bool:
        explicit = getattr(cfg, "_explicit_keys", None)
        if explicit is not None:
            return key in explicit
        return any(  # a config built in code: scan argv
            a.split("=", 1)[0].lstrip("-").replace("-", "_") == key
            for a in (argv or [])
            if "=" in a
        )

    user_model = dict(cfg.model)
    if user_model.get("name") == "speech_lstm" and not set_by_user("model.name"):
        user_model.pop("name", None)
    overlay(section, user_model)
    cfg.model = section
    # the criterion the model was trained with selects the decoder
    saved_crit = blob.get("criterion")
    if saved_crit and not set_by_user("criterion.name"):
        cfg.criterion.name = saved_crit
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    return cfg
