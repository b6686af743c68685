"""Parity of the port's data path, task and config against the JAX package.

On seeded corpora (``tests/utils.make_corpus`` for Kaldi ``feat`` entries, a
WAV corpus written the same way, a directory of noise WAVs), the port's
``SpeechRecognitionEspressoTask.get_batch_iterator`` gives the same batches
as JAX's, bit for bit: the same order, index sets, padding, arrays, dtypes
and counts, for ``feature_type`` ``precomputed``, ``fbank`` (with global
CMVN and delta-deltas), ``mfcc`` and ``device_fbank``, with T x U batching
by ``max_tokens``, ``update_freq`` 2, speed perturbation and noise on the
train split, dynamic batching, a mid-epoch resume and thread workers. The
host pieces under it (manifests, Kaldi matrices compressed or not, WAV
reading, host fbank and MFCC, the transforms, the native and NumPy batch
packing, edit counts) are held to JAX's directly, and the recipe's yaml,
the written-out recipe of ``chip_smoke.py`` and the recipe's model config
to JAX's. numpy and host code only: nothing here compiles a JAX program.
"""

import dataclasses
import json
import os
import pickle
import struct
import sys
import wave
from collections import OrderedDict

import numpy as np
import pytest
import torch

from espresso_tpu import config as jax_config
from espresso_tpu import tasks as jax_tasks
from espresso_tpu.clib import batched_edit_counts as jax_edit_counts
from espresso_tpu.data import audio as jax_audio
from espresso_tpu.data import batching as jax_batching
from espresso_tpu.data import kaldi_io as jax_kaldi_io
from espresso_tpu.data.manifest import load_manifest as jax_load_manifest
from espresso_tpu.features.fbank import mfcc_numpy as jax_mfcc_numpy
from espresso_tpu.features.fbank import fbank_numpy as jax_fbank_numpy
from espresso_tpu.features.fbank import num_samples_to_num_frames
from espresso_tpu.features import transforms as jax_transforms
from espresso_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from espresso_tpu_torch import clib
from espresso_tpu_torch import config as port_config
from espresso_tpu_torch import tasks as port_tasks
from espresso_tpu_torch.data import audio, batching, kaldi_io
from espresso_tpu_torch.data.manifest import load_manifest
from espresso_tpu_torch.features import fbank as port_fbank
from espresso_tpu_torch.features import transforms
from espresso_tpu_torch.features.fbank_kernels import fbank_lengths
from utils import make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE_YAML = os.path.join(ROOT, "examples", "asr_librispeech", "conformer_transducer_librispeech.yaml")
WORDS = ["ab", "cd", "efg", "gab", "dec"]


def _write_wav(path, pcm, rate=16000, width=2, channels=1):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def make_wave_corpus(root, split, num_utts, seed, token_text=False):
    """{split}.json of 16 kHz WAV files of 0.2-0.7 s with ``text`` (or
    pre-tokenised ``token_text``) and, for every other entry,
    ``utt2num_frames``; the char dictionary beside it."""
    rng = np.random.default_rng(seed)
    manifest = OrderedDict()
    for i in range(num_utts):
        utt = f"{split}_{i:03d}"
        S = int(rng.integers(3200, 11200))
        pcm = (rng.standard_normal(S) * 3000).astype("<i2")
        path = os.path.join(root, f"{utt}.wav")
        _write_wav(path, pcm)
        words = rng.choice(WORDS, size=rng.integers(1, 4))
        entry = {"wave": path}
        if token_text:
            entry["token_text"] = " <space> ".join(" ".join(w) for w in words)
        else:
            entry["text"] = " ".join(words)
        if i % 2 == 0:
            entry["utt2num_frames"] = str(1 + (S - 400) // 160)
        manifest[utt] = entry
    with open(os.path.join(root, f"{split}.json"), "w") as f:
        json.dump(manifest, f)
    dict_path = os.path.join(root, "dict.txt")
    if not os.path.exists(dict_path):
        with open(dict_path, "w") as f:
            for s in ["<space>"] + sorted("abcdefg"):
                f.write(f"{s} 10\n")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A feat corpus (train 24 utterances of 38-44 frames, so that lengths
    tie and the shuffle's tie-break shows; valid 10; 12-dim frames), a WAV
    corpus (train 16, valid 8; the valid split pre-tokenised), global CMVN
    stats of 40 bins and two noise WAVs."""
    feats = str(tmp_path_factory.mktemp("feats"))
    make_corpus(feats, "train", num_utts=24, feat_dim=12, min_frames=38, max_frames=44, seed=0)
    make_corpus(feats, "valid", num_utts=10, feat_dim=12, seed=1)
    waves = str(tmp_path_factory.mktemp("waves"))
    make_wave_corpus(waves, "train", 16, seed=2)
    make_wave_corpus(waves, "valid", 8, seed=3, token_text=True)
    rng = np.random.default_rng(4)
    np.savez(os.path.join(waves, "cmvn.npz"), mean=rng.standard_normal(40).astype(np.float32),
             std=rng.uniform(0.5, 2.0, 40).astype(np.float32))
    noise = os.path.join(waves, "noise")
    os.makedirs(noise)
    for i in range(2):
        _write_wav(os.path.join(noise, f"n{i}.wav"), (rng.standard_normal(4000 + 3000 * i) * 800).astype("<i2"))
    return {"feats": feats, "waves": waves, "noise": noise}


def _cfg_dicts(data, dataset):
    section = {"data": data, **dataset}
    return {
        "common": {"seed": 3},
        "task": {"name": "speech_recognition_espresso"},
        "criterion": {"name": "transducer_loss"},
        "model": {"name": "conformer_transducer_librispeech"},
        "dataset": section,
    }


def _tasks(data, dataset):
    cfg = _cfg_dicts(data, dataset)
    return (
        jax_tasks.setup_task(jax_config.load_config_dict(cfg)),
        port_tasks.setup_task(port_config.load_config_dict(cfg)),
    )


def _assert_same_group(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


# (corpus, split, dataset section, max_tokens, max_sentences, update_freq)
CASES = {
    "precomputed": ("feats", "train", dict(feat_dim=12, num_batch_buckets=3), 300, None, 1),
    "precomputed_update_freq_2_threads": (
        "feats", "train", dict(feat_dim=12, num_batch_buckets=3, num_workers=2, worker_backend="thread"),
        None, 4, 2),
    "fbank_cmvn_deltas": (
        "waves", "valid", dict(feature_type="fbank", feat_dim=40, delta_deltas=True,
                               global_cmvn_stats_path="cmvn.npz", num_batch_buckets=3), 200, None, 1),
    "mfcc_speed": ("waves", "train", dict(feature_type="mfcc", feat_dim=40, speed_perturb=[0.9, 1.0, 1.1],
                                          num_batch_buckets=2), 250, None, 1),
    "device_fbank_txu_speed_noise_threads": (
        "waves", "train",
        dict(feature_type="device_fbank", batch_based_on_both_src_tgt=True, num_batch_buckets=3,
             required_batch_size_multiple=2, speed_perturb=[0.9, 1.0, 1.1], noise_augment_path="noise",
             noise_rate=0.6, num_workers=2, worker_backend="thread"), 3000, None, 2),
    "device_fbank_dynamic": ("waves", "valid", dict(feature_type="device_fbank", num_batch_buckets=0),
                             120, None, 1),
}


def _case(corpora, name):
    corpus, split, dataset, max_tokens, max_sentences, update_freq = CASES[name]
    root = corpora[corpus]
    dataset = dict(dataset)
    for key in ("global_cmvn_stats_path", "noise_augment_path"):
        if key in dataset:
            dataset[key] = os.path.join(root, dataset[key])
    jt, pt = _tasks(root, dataset)
    kw = dict(max_tokens=max_tokens, max_sentences=max_sentences, seed=5, update_freq=update_freq)
    return jt, pt, split, kw


@pytest.mark.parametrize("name", list(CASES))
def test_batches_match_jax(corpora, name):
    """Two epochs of the iterator: every group equal to JAX's, bit for bit;
    the tasks' probed feature widths equal."""
    jt, pt, split, kw = _case(corpora, name)
    jitr = jt.get_batch_iterator(jt.load_dataset(split), **kw)
    pitr = pt.get_batch_iterator(pt.load_dataset(split), **kw)
    assert pt.feat_dim == jt.feat_dim
    n = 0
    for _ in range(2):
        want, got = list(jitr.next_epoch_itr()), list(pitr.next_epoch_itr())
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _assert_same_group(g, w)
        n += len(got)
        assert pitr.state_dict() == jitr.state_dict()
    assert n > 2


@pytest.mark.parametrize("name", ["precomputed", "device_fbank_txu_speed_noise_threads"])
def test_mid_epoch_resume_matches_jax(corpora, name):
    """A state_dict taken after two groups of epoch 2 resumes, in a new
    iterator, on the same groups as JAX's resumed iterator and as the rest
    of the uninterrupted epoch (in-process and with thread workers)."""
    jt, pt, split, kw = _case(corpora, name)
    pds = pt.load_dataset(split)
    resumed = {}
    for name, task, ds in (("jax", jt, jt.load_dataset(split)), ("port", pt, pds)):
        itr = task.get_batch_iterator(ds, **kw)
        list(itr.next_epoch_itr())
        epoch = itr.next_epoch_itr()
        full = [next(epoch) for _ in range(2)]
        sd = itr.state_dict()
        full += list(epoch)
        again = task.get_batch_iterator(ds, **kw)
        again.load_state_dict(sd)
        resumed[name] = (sd, list(again.next_epoch_itr()), full)
    (jsd, jrest, jfull), (psd, prest, pfull) = resumed["jax"], resumed["port"]
    assert psd == jsd and psd["epoch"] == 2 and psd["iterations_in_epoch"] == 2
    assert len(prest) == len(jrest) == len(pfull) - 2 > 0
    for g, w, f in zip(prest, jrest, pfull[2:]):
        _assert_same_group(g, w)
        _assert_same_group(g, f)


def test_manifests_and_kaldi_matrices_match_jax(corpora, tmp_path):
    """Manifest entries (sharded splits combined), Kaldi FM, CM and CM2
    matrices at ark offsets, and WAV samples of every width, equal to
    JAX's readers."""
    def entries(fn, *args, **kw):
        return [dataclasses.astuple(e) for e in fn(*args, **kw)]

    for root, split in ((corpora["feats"], "train"), (corpora["waves"], "valid")):
        assert entries(load_manifest, root, split) == entries(jax_load_manifest, root, split)
    shard = tmp_path / "shard"
    shard.mkdir()
    for k, n in ((0, 3), (1, 2), (2, 4)):
        make_corpus(str(shard), "train" + (str(k) if k else ""), num_utts=n, seed=10 + k)
    got = entries(load_manifest, str(shard), "train")
    assert len(got) == 9 and got == entries(jax_load_manifest, str(shard), "train")
    assert entries(load_manifest, str(shard), "train", combine=False) == got[:3]

    rng = np.random.default_rng(6)
    rows, cols = 7, 5
    ark = tmp_path / "m.ark"
    offsets = []
    with open(ark, "wb") as f:
        f.write(b"fm ")
        offsets.append(f.tell())
        kaldi_io.write_mat(f, rng.standard_normal((rows, cols)).astype(np.float32))
        f.write(b"cm ")
        offsets.append(f.tell())
        f.write(b"\x00BCM " + struct.pack("<ffii", -3.0, 6.0, rows, cols))
        f.write(np.sort(rng.integers(0, 65536, (cols, 4)), 1).astype(np.uint16).tobytes())
        f.write(rng.integers(0, 256, (cols, rows)).astype(np.uint8).tobytes())
        f.write(b"cm2 ")
        offsets.append(f.tell())
        f.write(b"\x00BCM2 " + struct.pack("<ffii", -1.5, 2.5, rows, cols))
        f.write(rng.integers(0, 65536, (rows, cols)).astype(np.uint16).tobytes())
    for off in offsets:
        got, want = kaldi_io.read_mat(f"{ark}:{off}"), jax_kaldi_io.read_mat(f"{ark}:{off}")
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()

    for width, channels in ((1, 1), (2, 2), (4, 1)):
        path = str(tmp_path / f"w{width}{channels}.wav")
        dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
        hi = {1: 256, 2: 1 << 15, 4: 1 << 31}[width]
        pcm = rng.integers(0 if width == 1 else -hi, hi, 300 * channels).astype(dtype)
        _write_wav(path, pcm, rate=8000, width=width, channels=channels)
        (g, gsr), (w, wsr) = audio.read_wav(path), jax_audio.read_wav(path)
        assert gsr == wsr == 8000 and g.tobytes() == w.tobytes()
    cmd = f"cat {path} |"
    assert audio.read_audio(cmd, "command")[0].tobytes() == jax_audio.read_audio(cmd, "command")[0].tobytes()


def test_host_features_and_transforms_match_jax(corpora):
    """fbank_numpy, mfcc_numpy, delta_deltas_np, speed_perturb,
    choose_speed_rate and NoiseAugment bit for bit; the fbank kernel's
    length rule (fbank_lengths) equals the host frame count that the
    waveform collater writes."""
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal(5000) * 2000).astype(np.float32)
    for fn, jax_fn in ((port_fbank.fbank_numpy, jax_fbank_numpy), (port_fbank.mfcc_numpy, jax_mfcc_numpy)):
        g, w = fn(wav, num_mel_bins=40), jax_fn(wav, num_mel_bins=40)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), fn.__name__
    feats = rng.standard_normal((30, 12)).astype(np.float32)
    assert transforms.delta_deltas_np(feats).tobytes() == jax_transforms.delta_deltas_np(feats).tobytes()
    for rate in (0.9, 1.0, 1.1):
        assert transforms.speed_perturb(wav, rate).tobytes() == jax_transforms.speed_perturb(wav, rate).tobytes()
    rates = [0.9, 1.0, 1.1]
    draws = [transforms.choose_speed_rate(rates, 3, e, i) for e in (1, 2) for i in range(20)]
    assert draws == [jax_transforms.choose_speed_rate(rates, 3, e, i) for e in (1, 2) for i in range(20)]
    assert len(set(draws)) == 3
    noise, jnoise = (m.NoiseAugment(corpora["noise"], rate=0.6, seed=3) for m in (transforms, jax_transforms))
    mixed = 0
    for i in range(12):
        g, w = noise(wav, 16000, 2, i), jnoise(wav, 16000, 2, i)
        assert g.tobytes() == w.tobytes()
        mixed += g is not wav
    assert 0 < mixed < 12
    n = np.arange(0, 4000, 7)
    want = [num_samples_to_num_frames(int(k)) for k in n]
    got = fbank_lengths(torch.from_numpy(n), 400, 160, 10 ** 6)
    assert got.tolist() == want


@pytest.mark.parametrize("max_tokens,max_sentences,mult", [(4000, None, 8), (None, 6, 4), (2500, 16, 3)])
def test_batch_packing_native_and_numpy_match_jax(monkeypatch, max_tokens, max_sentences, mult):
    """batch_by_size through the native library and through the NumPy
    loop, and the bucketing helpers, equal to JAX's."""
    rng = np.random.default_rng(max_sentences or 0)
    sizes = rng.integers(20, 900, 500).astype(np.int64)
    sizes[37] = 5000  # one item past the budget: a batch of its own
    order = np.argsort(sizes, kind="stable")
    assert clib.native_paths()["batching"]
    want = jax_batching.batch_by_size(order, sizes[order], max_tokens, max_sentences, mult)
    native = batching.batch_by_size(order, sizes[order], max_tokens, max_sentences, mult)
    monkeypatch.setattr(clib, "batching_lib", lambda: None)
    numpy_path = batching.batch_by_size(order, sizes[order], max_tokens, max_sentences, mult)
    assert len(native) == len(numpy_path) == len(want) > 5
    for a, b, w in zip(native, numpy_path, want):
        assert a.tolist() == b.tolist() == w.tolist()
    buckets = batching.quantile_buckets(sizes, 7)
    np.testing.assert_array_equal(buckets, jax_batching.quantile_buckets(sizes, 7))
    np.testing.assert_array_equal(batching.assign_buckets(sizes, buckets),
                                  jax_batching.assign_buckets(sizes, buckets))
    got = batching.bucket_batches(order, sizes, buckets, max_tokens, max_sentences, mult)
    exp = jax_batching.bucket_batches(order, sizes, buckets, max_tokens, max_sentences, mult)
    assert [(c.tolist(), n) for c, n in got] == [(c.tolist(), n) for c, n in exp]
    kept, ignored = batching.filter_by_size(order, sizes, 800, sizes // 10, 60)
    jkept, jignored = jax_batching.filter_by_size(order, sizes, 800, sizes // 10, 60)
    assert kept.tolist() == jkept.tolist() and ignored == jignored


def test_batched_edit_counts_match_jax():
    rng = np.random.default_rng(8)
    refs = [rng.integers(0, 6, rng.integers(0, 15)).tolist() for _ in range(40)]
    hyps = [rng.integers(0, 6, rng.integers(0, 15)).tolist() for _ in range(40)]
    got = clib.batched_edit_counts(refs, hyps)
    np.testing.assert_array_equal(got, jax_edit_counts(refs, hyps))
    # corr + sub + del is the reference's length; corr + sub + ins the hypothesis'
    assert (got[:, 0] + got[:, 1] + got[:, 3]).tolist() == [len(r) for r in refs]
    assert (got[:, 0] + got[:, 1] + got[:, 2]).tolist() == [len(h) for h in hyps]


def test_dataset_pickles_for_spawn_workers(corpora):
    """A process worker's copy: the feature cache shipped empty, the lock
    dropped and made anew; the copy collates the same batch."""
    _, pt, split, kw = _case(corpora, "fbank_cmvn_deltas")
    ds = pt.load_dataset(split)
    spec = ds.make_batch_specs(200, None, num_buckets=3)[0]
    first = ds.collate(spec)
    assert len(ds._feat_cache) > 0
    copy = pickle.loads(pickle.dumps(ds))
    assert len(copy._feat_cache) == 0 and copy._feat_cache_lock is not ds._feat_cache_lock
    with copy._feat_cache_lock:
        pass
    _assert_same_group(copy.collate(spec), first)


def test_recipe_config_matches_jax(corpora, monkeypatch):
    """The recipe yaml through both packages' parse_config gives equal
    values on every field the port carries, and every field of JAX's that
    the port does not carry is at JAX's default, so the recipe sets nothing
    the port drops; such a key raises in the port, and a ``distributed``
    setting that asks for more than one device raises where the CLIs check
    it; ``generation`` is carried whole.
    ``chip_smoke.RECIPE`` (the yaml's values written out, for a card
    machine without PyYAML) gives the same tree; the task's model config
    at the recipe's arch equals JAX's field by field, and every field of
    JAX's that the port does not carry is at JAX's default."""
    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    argv = ["--config", RECIPE_YAML, f"dataset.data={corpora['waves']}", "dataset.num_workers=2"]
    jcfg, pcfg = jax_config.parse_config(argv), port_config.parse_config(argv)
    want = jax_config.config_to_dict(jcfg)
    jdefault = jax_config.config_to_dict(jax_config.EspressoConfig())
    got = port_config.config_to_dict(pcfg)
    assert got["model"] == want["model"]
    for section, fields in want.items():
        if section == "model":
            continue
        for name, value in fields.items():
            if name in got.get(section, {}):
                assert got[section][name] == value, f"{section}.{name}"
            else:
                assert value == jdefault[section][name], f"{section}.{name}"
    assert all(set(fields) <= set(want[section]) for section, fields in got.items() if section != "model")
    for key in ("criterion.label_smoothing=0.1", "common.prng_impl=rbg"):
        with pytest.raises(KeyError):
            port_config.parse_config([key])
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        port_config.check_single_device(port_config.parse_config(["distributed.fsdp=true"]).distributed)
    assert port_config.parse_config(["generation.beam=4"]).generation.beam == 4
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    recipe = port_config.load_config_dict(chip_smoke.RECIPE)
    plain = port_config.parse_config(["--config", RECIPE_YAML])
    assert port_config.config_to_dict(recipe) == port_config.config_to_dict(plain)

    jt, pt = jax_tasks.setup_task(jcfg), port_tasks.setup_task(pcfg)
    jt.load_dataset("valid"), pt.load_dataset("valid")
    jt.build_model()
    _, got = pt.build_model_config()
    want, jdefault = jt.model_cfg, JaxTransducerConfig()
    for cfg_got, cfg_want, default in ((got, want, jdefault), (got.encoder, want.encoder, jdefault.encoder)):
        names = {f.name for f in dataclasses.fields(cfg_got)}
        for f in dataclasses.fields(cfg_want):
            if dataclasses.is_dataclass(getattr(cfg_want, f.name)):
                continue
            if f.name in names:
                assert getattr(cfg_got, f.name) == getattr(cfg_want, f.name), f.name
            else:
                assert getattr(cfg_want, f.name) == getattr(default, f.name), f.name
    assert got.vocab_size == len(pt.dictionary) and got.pad_index == pt.dictionary.pad() == 1
    assert got.encoder.encoder_layers == 16 and got.feat_dim == 80
