"""Tasks: dataset, model and criterion wiring.

Counterpart of ``espresso_tpu/tasks.py`` for the ``speech_recognition_espresso``
task (tasks.py:36-212) and ``setup_task`` (:463): the AsrDictionary (blank =
bos for CTC and transducer criteria), datasets from JSON manifests, the
bucketed epoch batch iterator, the model from the named architecture with
the ``model`` section merged over its preset, and the criterion. The model
is built on ``device`` (the card unless the caller asks for the CPU), in
fp32: the train state makes its compute copies. ``build_valid_decoder``
(tasks.py:214-230) and ``build_generator`` (:232-303) choose, for the
transducer, its greedy decoder (the valid pass's WER, a beam of at most 1)
or its AES beam search, and for the cross-entropy criteria (the attention
encoder-decoder) ``decode/greedy.py``'s greedy decoder (the valid pass's
WER) or ``decode/beam_search.py``'s beam search, each fused with an LSTM LM
through ``lm=`` / ``lm_weight=``, and for ``ctc_loss`` (the encoder-only
models) ``decode/ctc_decoder.py``'s greedy decoder (the valid pass's WER,
a beam of at most 1) or its prefix beam search (which takes an LM and, as
JAX's, never reads it).
``language_modeling_for_asr`` (tasks.py:414-461) trains the LSTM LM on
``{split}.bin``/``.idx`` token streams (``prep binarize``,
``data/indexed_dataset.py``) or, without them, ``{split}.txt``
(``data/lm_dataset.py``); it validates by perplexity alone. The hybrid
task is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import espresso_tpu_torch.models.encoder_models  # noqa: F401 — populate the model registry
import espresso_tpu_torch.models.lstm_lm  # noqa: F401
import espresso_tpu_torch.models.speech_lstm  # noqa: F401
import espresso_tpu_torch.models.speech_transformer  # noqa: F401
import espresso_tpu_torch.models.transducer  # noqa: F401
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.data.dataset import AsrDataset
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.data.encoders import CharactersAsr
from espresso_tpu_torch.data.iterators import EpochBatchIterator
from espresso_tpu_torch.data.manifest import load_manifest
from espresso_tpu_torch.registry import ARCHITECTURES, MODELS, TASKS, apply_architecture

logger = logging.getLogger(__name__)


@TASKS.register("speech_recognition_espresso")
class SpeechRecognitionEspressoTask:
    """End-to-end ASR task (reference speech_recognition.py:272)."""

    def __init__(self, cfg: EspressoConfig):
        self.cfg = cfg
        crit = cfg.criterion.name
        enable_bos = crit in ("ctc_loss", "transducer_loss")
        # transducer prev_output_tokens is eos-led (input feeding) while the
        # loss takes the raw targets: autoregressive collation, the loss
        # strips by lengths
        self.autoregressive = crit != "ctc_loss"
        dict_path = cfg.dataset.dict or os.path.join(cfg.dataset.data, "dict.txt")
        self.dictionary = AsrDictionary.load(
            dict_path, enable_bos=enable_bos, non_lang_syms=cfg.dataset.non_lang_syms
        )
        self.tokenizer = CharactersAsr()
        self.datasets: Dict[str, AsrDataset] = {}
        self.feat_dim = cfg.dataset.feat_dim
        self.model_cfg = None

    # -- data ---------------------------------------------------------------
    def load_dataset(self, split: str) -> AsrDataset:
        if split in self.datasets:
            return self.datasets[split]
        dcfg = self.cfg.dataset
        entries = load_manifest(dcfg.data, split)
        device_feats = dcfg.feature_type in ("device_fbank", "waveform")
        is_train = split == dcfg.train_subset
        noise = None
        if is_train and dcfg.noise_augment_path:
            from espresso_tpu_torch.features.transforms import NoiseAugment

            noise = NoiseAugment(
                dcfg.noise_augment_path,
                snr_min=dcfg.noise_snr_min,
                snr_max=dcfg.noise_snr_max,
                rate=dcfg.noise_rate,
                seed=self.cfg.common.seed,
            )
        ds = AsrDataset(
            entries,
            self.dictionary,
            feat_dim=dcfg.feat_dim,
            feature_type=dcfg.feature_type,
            sample_rate=dcfg.sample_rate,
            autoregressive=self.autoregressive,
            tokenizer=self.tokenizer,
            global_cmvn_stats_path=None if device_feats else dcfg.global_cmvn_stats_path,
            device_features=device_feats,
            speed_perturb_rates=dcfg.speed_perturb,
            apply_delta_deltas=dcfg.delta_deltas and not device_feats,
            noise_augment=noise,
            transforms_seed=self.cfg.common.seed,
            is_train=is_train,
        )
        if device_feats:
            if dcfg.delta_deltas:
                # deltas are appended on the card after fbank
                self.feat_dim = 3 * dcfg.feat_dim
        else:
            # probe feat dim from the first utterance (reference :355-378)
            probe = ds.get_features(0)
            if probe.shape[1] != self.feat_dim:
                logger.info("probed feat_dim=%d from data", probe.shape[1])
                self.feat_dim = probe.shape[1]
        self.datasets[split] = ds
        return ds

    def get_batch_iterator(
        self,
        dataset: AsrDataset,
        max_tokens: Optional[int],
        max_sentences: Optional[int],
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        shuffle: bool = True,
        epoch: int = 1,
        update_freq: int = 1,
    ) -> EpochBatchIterator:
        """The bucketed, checkpointable iterator over ``dataset``: each item
        is a group of ``update_freq`` same-shape batches stacked on a leading
        microbatch axis (``AsrDataset.collate_group``), numpy on the host."""
        dcfg = self.cfg.dataset
        extra = {}
        if dcfg.batch_based_on_both_src_tgt and isinstance(dataset, AsrDataset):
            extra["batch_based_on_both_src_tgt"] = True

        def make_batches(ep: int):
            specs = dataset.make_batch_specs(
                max_tokens=max_tokens,
                max_sentences=max_sentences,
                num_buckets=dcfg.num_batch_buckets,
                required_batch_size_multiple=dcfg.required_batch_size_multiple,
                max_source_positions=dcfg.max_source_positions,
                max_target_positions=dcfg.max_target_positions,
                shuffle=shuffle,
                seed=seed,
                epoch=ep,
                **extra,
            )
            return dataset.group_specs(specs, update_freq)

        return EpochBatchIterator(
            make_batches,
            dataset.collate_group,
            seed=seed,
            num_shards=num_shards,
            shard_id=shard_id,
            buffer_size=dcfg.data_buffer_size,
            shuffle=shuffle,
            epoch=epoch,
            num_workers=dcfg.num_workers,
            worker_backend=dcfg.worker_backend,
        )

    # -- model --------------------------------------------------------------
    def build_model_config(self):
        """The model config: the architecture's preset, the ``model``
        section merged over it (nested dicts into nested configs, lists
        into tuples; an unknown key raises), then the task's vocab size,
        feature width and pad index (tasks.py:156-189)."""
        model_section = dict(self.cfg.model)
        arch = model_section.pop("name")
        base_name = ARCHITECTURES[arch][0] if arch in ARCHITECTURES else arch
        model_cfg = MODELS.config_class(base_name)()
        apply_architecture(arch, model_cfg)

        def merge(target, overrides: Dict[str, Any]):
            for key, value in overrides.items():
                if not hasattr(target, key):
                    raise KeyError(f"unknown model config key {key!r}")
                cur = getattr(target, key)
                if dataclasses.is_dataclass(cur) and isinstance(value, dict):
                    merge(cur, value)
                    continue
                if isinstance(cur, tuple):
                    if isinstance(value, (int, float)):
                        value = (value,)
                    if isinstance(value, (list, tuple)):
                        value = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in value)
                setattr(target, key, value)

        merge(model_cfg, model_section)
        model_cfg.vocab_size = len(self.dictionary)
        if hasattr(model_cfg, "feat_dim"):  # an LM's config has none
            model_cfg.feat_dim = self.feat_dim
        if hasattr(model_cfg, "pad_index"):
            model_cfg.pad_index = self.dictionary.pad()
        return base_name, model_cfg

    def build_model(self, device="cuda"):
        """The model of the recipe's architecture, fp32, on ``device``; its
        weights are the modules' seeded init (seed torch first)."""
        base_name, model_cfg = self.build_model_config()
        self.model_cfg = model_cfg
        return MODELS.get(base_name)(model_cfg).to(device)

    def build_criterion(self):
        from espresso_tpu_torch.criterions import build_criterion

        return build_criterion(self.cfg.criterion, self)

    # -- decoding hooks (per-criterion decoders, reference :479-596) --------
    def build_valid_decoder(self, model):
        """The valid pass's greedy WER decoder: the transducer's, CTC's,
        else the attention encoder-decoder's."""
        if self.cfg.criterion.name == "ctc_loss":
            from espresso_tpu_torch.decode.ctc_decoder import CTCGreedyDecoder

            return CTCGreedyDecoder(model, self.dictionary)
        if self.cfg.criterion.name == "transducer_loss":
            from espresso_tpu_torch.decode.transducer_greedy import TransducerGreedyDecoder

            return TransducerGreedyDecoder(model, self.dictionary)
        from espresso_tpu_torch.decode.greedy import SimpleGreedyDecoder

        return SimpleGreedyDecoder(model, self.dictionary)

    def build_generator(self, model, gen_cfg=None, lm=None, lm_weight=0.0):
        """The inference decoder: for the transducer and CTC their greedy
        decoder at a beam of at most 1, else the AES beam search or the CTC
        prefix beam search; for the cross-entropy criteria the beam search
        at any beam; ``lm`` fused at ``lm_weight`` (CTC's takes it unread)."""
        gen_cfg = gen_cfg or self.cfg.generation
        if self.cfg.criterion.name == "ctc_loss":
            from espresso_tpu_torch.decode import ctc_decoder

            if gen_cfg.beam > 1:
                return ctc_decoder.CTCPrefixBeamSearchDecoder(
                    model, self.dictionary, beam_size=gen_cfg.beam, lm=lm, lm_weight=lm_weight
                )
            return ctc_decoder.CTCGreedyDecoder(model, self.dictionary)
        if self.cfg.criterion.name != "transducer_loss":
            from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder

            return BeamSearchDecoder(
                model,
                self.dictionary,
                beam_size=gen_cfg.beam,
                max_len_a=gen_cfg.max_len_a,
                max_len_b=gen_cfg.max_len_b,
                min_len=gen_cfg.min_len,
                len_penalty=gen_cfg.lenpen,
                eos_factor=gen_cfg.eos_factor,
                temperature=gen_cfg.temperature,
                lm=lm,
                lm_weight=lm_weight,
                sampling=gen_cfg.sampling,
                no_repeat_ngram_size=gen_cfg.no_repeat_ngram_size,
                diverse_beam_groups=gen_cfg.diverse_beam_groups,
            )
        if gen_cfg.beam <= 1:
            from espresso_tpu_torch.decode.transducer_greedy import TransducerGreedyDecoder

            return TransducerGreedyDecoder(
                model,
                self.dictionary,
                max_num_expansions_per_step=gen_cfg.max_num_expansions_per_step,
                model_predicts_eos=gen_cfg.model_predicts_eos,
                max_out_factor=gen_cfg.max_out_factor,
            )
        from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder

        return TransducerBeamSearchDecoder(
            model,
            self.dictionary,
            beam_size=gen_cfg.beam,
            expansion_beta=gen_cfg.expansion_beta,
            expansion_gamma=gen_cfg.expansion_gamma,
            max_num_expansions_per_step=gen_cfg.max_num_expansions_per_step,
            lm=lm,
            lm_weight=lm_weight,
            model_predicts_eos=gen_cfg.model_predicts_eos,
            prefix_alpha=gen_cfg.prefix_alpha,
            max_out_factor=gen_cfg.max_out_factor,
        )


@TASKS.register("language_modeling_for_asr")
class LanguageModelingForASRTask(SpeechRecognitionEspressoTask):
    """LM task (espresso/tasks/language_modeling_for_asr.py): trains the
    subword/word LMs used for fusion. Data = ``{split}.bin``/``.idx`` when
    present, else ``{split}.txt``, one sentence per line, encoded with the
    AsrDictionary (``dataset.dict`` or ``data/dict.txt``, no bos)."""

    def __init__(self, cfg: EspressoConfig):
        self.cfg = cfg
        dict_path = cfg.dataset.dict or os.path.join(cfg.dataset.data, "dict.txt")
        self.dictionary = AsrDictionary.load(dict_path, non_lang_syms=cfg.dataset.non_lang_syms)
        self.tokenizer = None  # LM text is pre-tokenized (reference recipes)
        self.datasets = {}
        self.feat_dim = 0
        self.autoregressive = True
        self.model_cfg = None

    def load_dataset(self, split: str):
        if split in self.datasets:
            return self.datasets[split]
        prefix = os.path.join(self.cfg.dataset.data, split)
        if os.path.exists(prefix + ".bin"):
            from espresso_tpu_torch.data.indexed_dataset import LMBlockDataset

            ds = LMBlockDataset(
                prefix,
                self.dictionary,
                block_size=self.cfg.dataset.tokens_per_sample,
                break_mode=self.cfg.dataset.sample_break_mode,
            )
        else:
            from espresso_tpu_torch.data.lm_dataset import LMTextDataset

            ds = LMTextDataset(prefix + ".txt", self.dictionary, tokenizer=self.tokenizer)
        self.datasets[split] = ds
        return ds

    def build_valid_decoder(self, model):
        return None  # perplexity only

    def build_generator(self, model, gen_cfg=None, lm=None, lm_weight=0.0):
        raise NotImplementedError("use eval_lm for language models")


def setup_task(cfg: EspressoConfig):
    return TASKS.build(cfg.task.name, cfg)
