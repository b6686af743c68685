"""ASR dataset: paired audio features + token targets, fixed-shape collation.

The port's own copy of ``espresso_tpu/data/dataset.py`` (AsrDataset, the
batch specs, their grouping for ``update_freq`` and the collaters), numpy
only, equal to the reference batch for batch: the same order, padding,
lengths and arrays. Rebuild of espresso/data/asr_dataset.py (AsrDataset
:139, collate :17-136) and espresso/data/feat_text_dataset.py:

  * Every batch is collated to a *bucketed* fixed shape (the reference's
    opt-in TPU path asr_bucket_pad_length_dataset.py is the default here),
    so the card sees at most ``num_batch_buckets`` shapes.
  * Batches padded up with repeated utterances carry ``weight=0`` rows so loss
    and WER accounting are exact.
  * ``prev_output_tokens`` is built by moving EOS to the front (or prepending
    BOS), matching reference collate :85-102.
  * Feature sources: Kaldi ``feats.scp`` matrices (ark offsets), raw wave
    files, or shell-command pipes with on-the-fly fbank/MFCC on the host
    (``fbank_numpy``), or, with ``device_features``, the waveforms
    themselves (``src_waveforms`` / ``num_samples``) for the on-device front
    (``train/trainer.py::make_device_feature_fn``, the fbank kernel).

Nothing here touches the card or imports torch at import time: spawn
workers re-import this module to collate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from espresso_tpu_torch.data import kaldi_io
from espresso_tpu_torch.data.audio import read_audio
from espresso_tpu_torch.data.batching import (
    bucket_batches,
    filter_by_size,
    quantile_buckets,
)
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.data.manifest import ManifestEntry
from espresso_tpu_torch.features.fbank import (
    fbank_numpy,
    mfcc_numpy,
    num_samples_to_num_frames,
)


@dataclass
class BatchSpec:
    indices: np.ndarray  # [bsz] dataset indices (tail may repeat for padding)
    num_real: int  # how many rows are real (rest are shape padding)
    src_bucket: int  # padded feature length
    tgt_bucket: int  # padded target length


class AsrDataset:
    """Paired (features, tokens) dataset over a manifest."""

    def __init__(
        self,
        entries: Sequence[ManifestEntry],
        dictionary: Optional[AsrDictionary],
        feat_dim: int = 80,
        feature_type: str = "precomputed",  # precomputed | fbank | mfcc
        sample_rate: int = 16000,
        autoregressive: bool = True,
        prepend_bos_as_input_feeding: bool = False,
        tokenizer=None,
        global_cmvn_stats_path: Optional[str] = None,
        device_features: bool = False,
        speed_perturb_rates: Optional[Sequence[float]] = None,
        apply_delta_deltas: bool = False,
        noise_augment=None,
        transforms_seed: int = 1,
        is_train: bool = False,
    ):
        self.entries = list(entries)
        self.dict = dictionary
        self.feat_dim = feat_dim
        self.feature_type = feature_type
        self.sample_rate = sample_rate
        self.autoregressive = autoregressive
        self.prepend_bos = prepend_bos_as_input_feeding
        self.tokenizer = tokenizer
        # train-time transforms (fairseq waveform/feature transform parity);
        # waveform transforms apply to wave/command entries only
        self.speed_rates = (
            list(speed_perturb_rates)
            if (is_train and speed_perturb_rates)
            else None
        )
        self.apply_delta_deltas = apply_delta_deltas
        self.noise_augment = noise_augment if is_train else None
        self.transforms_seed = transforms_seed
        self.cmvn_mean = self.cmvn_std = None
        if global_cmvn_stats_path:
            stats = np.load(global_cmvn_stats_path)
            self.cmvn_mean = stats["mean"].astype(np.float32)
            self.cmvn_std = stats["std"].astype(np.float32)
        # device_features: collate raw waveforms; fbank runs fused on device
        # (reference on-the-fly torchaudio path, feat_text_dataset.py:144-149,
        # moved from host workers onto the card)
        self.device_features = device_features and all(
            e.kind in ("wave", "command") for e in self.entries
        )
        # bounded feature cache (reference AudioFeatCachedDataset /
        # AudioFeatInMemoryDataset, feat_text_dataset.py:171,:276)
        from collections import OrderedDict as _OD

        self._feat_cache: "Optional[_OD]" = _OD()
        self._feat_cache_max = 1024
        import threading as _threading

        self._feat_cache_lock = _threading.Lock()
        self._encode_targets()
        self.src_sizes = np.array(
            [
                e.num_frames if e.num_frames is not None else self._probe_frames(i)
                for i, e in enumerate(self.entries)
            ],
            dtype=np.int64,
        )
        if self.speed_rates is not None and min(self.speed_rates) < 1.0:
            # plan buckets for the worst-case stretch so slowed-down
            # utterances are never truncated
            stretch = 1.0 / min(self.speed_rates)
            self.src_sizes = np.ceil(self.src_sizes * stretch).astype(np.int64)
        self.tgt_sizes = np.array(
            [len(t) for t in self.targets], dtype=np.int64
        )

    # -- targets ------------------------------------------------------------
    def _encode_targets(self) -> None:
        self.targets: List[np.ndarray] = []
        for e in self.entries:
            # pre-tokenized token_text takes precedence (reference manifest
            # field, asr_prep_json --token-text-files)
            token_text = getattr(e, "token_text", None)
            if token_text is not None and self.dict is not None:
                self.targets.append(
                    self.dict.encode_line(
                        token_text, append_eos=self.autoregressive
                    )
                )
                continue
            if e.text is None or self.dict is None:
                self.targets.append(np.zeros(0, dtype=np.int32))
                continue
            text = e.text
            if self.tokenizer is not None:
                text = self.tokenizer.encode(text)
            elif self.dict.tokenizer is not None or self.dict.bpe is not None:
                text = self.dict.wordpiece_encode(text)
            self.targets.append(
                self.dict.encode_line(text, append_eos=self.autoregressive)
            )

    def _probe_frames(self, index: int) -> int:
        e = self.entries[index]
        if e.kind == "feat":
            return kaldi_io.read_mat(e.audio).shape[0]
        wav, sr = read_audio(e.audio, e.kind)
        return num_samples_to_num_frames(len(wav), sr)

    def __len__(self) -> int:
        return len(self.entries)

    # -- pickling (process-backend collate workers) ---------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_feat_cache_lock"] = None
        if self._feat_cache is not None:
            state["_feat_cache"] = type(self._feat_cache)()  # ship empty LRU
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        import threading as _threading

        self._feat_cache_lock = _threading.Lock()

    # -- feature access -----------------------------------------------------
    def _stochastic(self) -> bool:
        return self.speed_rates is not None or self.noise_augment is not None

    def get_features(self, index: int, epoch: int = 1) -> np.ndarray:
        use_cache = self._feat_cache is not None and not self._stochastic()
        if use_cache:
            # lock: thread-backend workers share this LRU
            with self._feat_cache_lock:
                if index in self._feat_cache:
                    self._feat_cache.move_to_end(index)
                    return self._feat_cache[index]
        mat = self._load_features(index, epoch)
        if use_cache:
            with self._feat_cache_lock:
                self._feat_cache[index] = mat
                if len(self._feat_cache) > self._feat_cache_max:
                    self._feat_cache.popitem(last=False)
        return mat

    def _transform_waveform(
        self, wav: np.ndarray, sr: int, index: int, epoch: int
    ) -> np.ndarray:
        if self.speed_rates is not None:
            from espresso_tpu_torch.features.transforms import (
                choose_speed_rate,
                speed_perturb,
            )

            rate = choose_speed_rate(
                self.speed_rates, self.transforms_seed, epoch, index
            )
            wav = speed_perturb(wav, rate)
        if self.noise_augment is not None:
            wav = self.noise_augment(wav, sr, epoch, index)
        return wav

    def _load_features(self, index: int, epoch: int = 1) -> np.ndarray:
        e = self.entries[index]
        if e.kind == "feat":
            mat = kaldi_io.read_mat(e.audio)
        else:
            wav, sr = read_audio(e.audio, e.kind)
            wav = self._transform_waveform(wav, sr, index, epoch)
            if self.feature_type == "mfcc":
                mat = mfcc_numpy(wav, sample_rate=sr, num_mel_bins=self.feat_dim)
            else:
                mat = fbank_numpy(wav, sample_rate=sr, num_mel_bins=self.feat_dim)
        if self.cmvn_mean is not None:
            mat = (mat - self.cmvn_mean) / self.cmvn_std
        if self.apply_delta_deltas:
            from espresso_tpu_torch.features.transforms import delta_deltas_np

            mat = delta_deltas_np(mat)
        return mat

    # -- sizes for batching ---------------------------------------------------
    def num_tokens(self, index: int, batch_on_both: bool = False) -> int:
        if batch_on_both:
            # transducer T*U memory batching (reference asr_dataset.py:369-382)
            return int(self.src_sizes[index] * max(self.tgt_sizes[index], 1))
        return int(self.src_sizes[index])

    def ordered_indices(
        self, shuffle: bool = True, seed: int = 1, epoch: int = 1
    ) -> np.ndarray:
        """Sort by tgt then src length, with random tie-break when shuffling
        (reference asr_dataset.py:392-408)."""
        if shuffle:
            rng = np.random.default_rng([seed, epoch])
            order = rng.permutation(len(self))
        else:
            order = np.arange(len(self))
        if len(self.tgt_sizes) and self.tgt_sizes.max() > 0:
            order = order[np.argsort(self.tgt_sizes[order], kind="stable")]
        return order[np.argsort(self.src_sizes[order], kind="stable")]

    # -- batch planning -------------------------------------------------------
    def make_batch_specs(
        self,
        max_tokens: Optional[int],
        max_sentences: Optional[int],
        num_buckets: int = 10,
        required_batch_size_multiple: int = 8,
        max_source_positions: int = 6000,
        max_target_positions: int = 1024,
        shuffle: bool = True,
        seed: int = 1,
        epoch: int = 1,
        tgt_pad_multiple: int = 32,
        batch_based_on_both_src_tgt: bool = False,
    ) -> List[BatchSpec]:
        indices = self.ordered_indices(shuffle=shuffle, seed=seed, epoch=epoch)
        indices, _ = filter_by_size(
            indices,
            self.src_sizes,
            max_source_positions,
            self.tgt_sizes if self.tgt_sizes.max() > 0 else None,
            max_target_positions,
        )
        # num_buckets=0: dynamic token-budget batching (the reference's
        # default GPU path, data_utils_fast.pyx semantics) — variable shapes,
        # the reference's GPU default
        if num_buckets <= 0:
            from espresso_tpu_torch.data.batching import batch_by_size

            batches = batch_by_size(
                indices,
                self.src_sizes[indices],
                max_tokens=max_tokens,
                max_sentences=max_sentences,
                required_batch_size_multiple=required_batch_size_multiple,
            )
            specs = []
            for chunk in batches:
                tgt_max = (
                    int(self.tgt_sizes[chunk].max()) if len(self.tgt_sizes) else 1
                )
                specs.append(
                    BatchSpec(
                        indices=chunk,
                        num_real=len(chunk),
                        src_bucket=int(self.src_sizes[chunk].max()),
                        tgt_bucket=max(tgt_max, 1),
                    )
                )
            return specs

        # transducer memory batching: budget the T*U lattice product
        # (reference asr_dataset.py:369-382, conformer yaml max-tokens 590000)
        if batch_based_on_both_src_tgt and self.tgt_sizes.max() > 0:
            sizes_for_batching = self.src_sizes * np.maximum(self.tgt_sizes, 1)
        else:
            sizes_for_batching = self.src_sizes
        bucket_sizes = quantile_buckets(
            sizes_for_batching[indices], min(num_buckets, len(indices))
        )
        raw = bucket_batches(
            indices,
            sizes_for_batching,
            bucket_sizes,
            max_tokens=max_tokens,
            max_sentences=max_sentences,
            required_batch_size_multiple=required_batch_size_multiple,
        )
        if batch_based_on_both_src_tgt and self.tgt_sizes.max() > 0:
            # re-derive the padded src length per batch (bucket keyed on T*U);
            # round up to multiples of 64 frames to bound the shape count
            raw = [
                (chunk, int(-(-int(self.src_sizes[chunk].max()) // 64) * 64))
                for chunk, _ in raw
            ]
        # fixed tgt pad per src bucket: dataset-wide max tgt in bucket, rounded
        bucket_tgt: Dict[int, int] = {}
        for chunk, src_bucket in raw:
            t = int(self.tgt_sizes[chunk].max()) if len(self.tgt_sizes) else 0
            bucket_tgt[src_bucket] = max(bucket_tgt.get(src_bucket, 1), t)
        for k in bucket_tgt:
            m = tgt_pad_multiple
            bucket_tgt[k] = max(-(-bucket_tgt[k] // m) * m, m)
        specs = []
        for chunk, src_bucket in raw:
            uniq = len(chunk)
            # rows appended by bucket_batches repeat the last index
            num_real = uniq
            for r in range(len(chunk) - 1, 0, -1):
                if chunk[r] == chunk[r - 1]:
                    num_real -= 1
                else:
                    break
            specs.append(
                BatchSpec(
                    indices=chunk,
                    num_real=num_real,
                    src_bucket=src_bucket,
                    tgt_bucket=bucket_tgt[src_bucket],
                )
            )
        return specs

    # -- update-freq grouping --------------------------------------------------
    @staticmethod
    def group_specs(specs: List[BatchSpec], update_freq: int) -> List[List[BatchSpec]]:
        """Group specs of identical shape into chunks of ``update_freq``
        (grad-accum microbatches share one shape). Short final
        chunks are padded with zero-weight copies of their last spec so every
        group is [update_freq, B, T, U]."""
        if update_freq <= 1:
            return [[s] for s in specs]
        from collections import defaultdict

        by_shape: Dict[Tuple[int, int, int], List[BatchSpec]] = defaultdict(list)
        for s in specs:
            by_shape[(len(s.indices), s.src_bucket, s.tgt_bucket)].append(s)
        groups: List[List[BatchSpec]] = []
        for shape_key, lst in by_shape.items():
            for i in range(0, len(lst), update_freq):
                chunk = list(lst[i : i + update_freq])
                while len(chunk) < update_freq:
                    pad_spec = BatchSpec(
                        indices=chunk[-1].indices,
                        num_real=0,  # all-zero weight: contributes nothing
                        src_bucket=chunk[-1].src_bucket,
                        tgt_bucket=chunk[-1].tgt_bucket,
                    )
                    chunk.append(pad_spec)
                groups.append(chunk)
        return groups

    def _collate_waveforms(self, spec: BatchSpec, epoch: int = 1) -> Dict[str, Any]:
        """Waveform collation for on-device feature extraction: frames are
        computed by the fbank kernel in the step (``fbank_fused``).
        src_bucket is in FRAMES (the batching currency); samples =
        (frames - 1) * shift + window."""
        from espresso_tpu_torch.features.fbank import MILLISECONDS_TO_SECONDS

        B = len(spec.indices)
        T, U = spec.src_bucket, spec.tgt_bucket
        shift = round(self.sample_rate * MILLISECONDS_TO_SECONDS * 10.0)
        window = round(self.sample_rate * MILLISECONDS_TO_SECONDS * 25.0)
        S = (T - 1) * shift + window
        wavs = np.zeros((B, S), dtype=np.float32)
        num_samples = np.zeros(B, dtype=np.int32)
        pad = self.dict.pad() if self.dict is not None else 0
        eos = self.dict.eos() if self.dict is not None else 0
        target = np.full((B, U), pad, dtype=np.int32)
        prev_output = np.full((B, U), pad, dtype=np.int32)
        tgt_lengths = np.zeros(B, dtype=np.int32)
        src_lengths = np.zeros(B, dtype=np.int32)
        utt_ids: List[str] = []
        for row, idx in enumerate(spec.indices):
            e = self.entries[int(idx)]
            wav, sr = read_audio(e.audio, e.kind)
            wav = self._transform_waveform(wav, sr, int(idx), epoch)
            L = min(len(wav), S)
            wavs[row, :L] = wav[:L]
            num_samples[row] = L
            src_lengths[row] = min(
                num_samples_to_num_frames(L, sr), T
            )
            utt_ids.append(e.utt_id)
            tgt = self.targets[int(idx)][:U]
            target[row, : len(tgt)] = tgt
            tgt_lengths[row] = len(tgt)
            if self.autoregressive and len(tgt) > 0:
                prev_output[row, 0] = eos
                prev_output[row, 1 : len(tgt)] = tgt[: len(tgt) - 1]
        weight = (np.arange(B) < spec.num_real).astype(np.float32)
        order = np.argsort(-src_lengths, kind="stable")
        return {
            "utt_ids": [utt_ids[i] for i in order],
            "src_waveforms": wavs[order],
            "num_samples": num_samples[order],
            "src_lengths": src_lengths[order],
            "target": target[order],
            "prev_output_tokens": prev_output[order],
            "tgt_lengths": tgt_lengths[order],
            "weight": weight[order],
            "ntokens": int((tgt_lengths * weight).sum()),
            "nsentences": spec.num_real,
        }

    def collate_group(self, group: List["BatchSpec"], epoch: int = 1) -> Dict[str, Any]:
        """Collate a same-shape spec group into stacked arrays
        [n_micro, B, ...]: the train step's microbatch axis."""
        parts = [self.collate(s, epoch) for s in group]
        out: Dict[str, Any] = {}
        keys = (
            ("src_waveforms", "num_samples")
            if self.device_features
            else ("src_frames",)
        ) + (
            "src_lengths",
            "target",
            "prev_output_tokens",
            "tgt_lengths",
            "weight",
        )
        for key in keys:
            out[key] = np.stack([p[key] for p in parts])
        out["utt_ids"] = [p["utt_ids"] for p in parts]
        out["ntokens"] = sum(p["ntokens"] for p in parts)
        out["nsentences"] = sum(p["nsentences"] for p in parts)
        return out

    # -- collation ------------------------------------------------------------
    def collate(self, spec: BatchSpec, epoch: int = 1) -> Dict[str, Any]:
        if self.device_features:
            return self._collate_waveforms(spec, epoch)
        B = len(spec.indices)
        T, U = spec.src_bucket, spec.tgt_bucket
        out_dim = self.feat_dim * (3 if self.apply_delta_deltas else 1)
        feats = np.zeros((B, T, out_dim), dtype=np.float32)
        src_lengths = np.zeros(B, dtype=np.int32)
        pad = self.dict.pad() if self.dict is not None else 0
        eos = self.dict.eos() if self.dict is not None else 0
        target = np.full((B, U), pad, dtype=np.int32)
        prev_output = np.full((B, U), pad, dtype=np.int32)
        tgt_lengths = np.zeros(B, dtype=np.int32)
        utt_ids: List[str] = []
        for row, idx in enumerate(spec.indices):
            mat = self.get_features(int(idx), epoch)
            L = min(mat.shape[0], T)
            feats[row, :L] = mat[:L]
            src_lengths[row] = L
            utt_ids.append(self.entries[int(idx)].utt_id)
            tgt = self.targets[int(idx)][:U]
            target[row, : len(tgt)] = tgt
            tgt_lengths[row] = len(tgt)
            if self.autoregressive and len(tgt) > 0:
                if self.prepend_bos:
                    prev_output[row, 0] = self.dict.bos()
                    prev_output[row, 1 : len(tgt)] = tgt[: len(tgt) - 1]
                else:
                    # move EOS to front (reference collate :85-102)
                    prev_output[row, 0] = eos
                    prev_output[row, 1 : len(tgt)] = tgt[: len(tgt) - 1]
        weight = (np.arange(B) < spec.num_real).astype(np.float32)
        # sort by descending src length within batch (reference collate :67)
        order = np.argsort(-src_lengths, kind="stable")
        return {
            "utt_ids": [utt_ids[i] for i in order],
            "src_frames": feats[order],
            "src_lengths": src_lengths[order],
            "target": target[order],
            "prev_output_tokens": prev_output[order],
            "tgt_lengths": tgt_lengths[order],
            "weight": weight[order],
            "ntokens": int((tgt_lengths * weight).sum())
            if self.tgt_sizes.max() > 0
            else int((src_lengths * weight).sum()),
            "nsentences": spec.num_real,
        }
