"""Parity of the port's on-device feature front against the JAX package.

fbank (the plain version ``fbank_fused`` runs on a CPU tensor) against JAX
``fbank_fused`` and ``fbank_pallas(interpret=True)`` and against the Kaldi
goldens; ``make_device_feature_fn`` with global CMVN and delta-deltas;
``apply_specaugment`` against JAX's given JAX's own draws; the port's draws
against JAX's bounds and distributions; and a port train step fed PCM
against one fed the front's frames. Everything is fp32 on the CPU at small
sizes (B <= 3, at most 2 s of audio).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.features import specaugment as jax_specaugment
from espresso_tpu.features.fbank import fbank_numpy
from espresso_tpu.features.pallas_fbank import fbank_fused as jax_fbank_fused
from espresso_tpu.features.pallas_fbank import fbank_pallas as jax_fbank_pallas
from espresso_tpu.train.trainer import make_device_feature_fn as jax_feature_fn
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.features.cmvn import (
    GlobalCMVN,
    compute_global_cmvn_stats,
    utterance_cmvn,
)
from espresso_tpu_torch.features.fbank_kernels import fbank_fused
from espresso_tpu_torch.features.specaugment import (
    SpecAugmentConfig,
    apply_specaugment,
    draw_specaugment,
)
from espresso_tpu_torch.train.trainer import make_device_feature_fn

# one second of audio and a bit: T = 1 + (S - 400) // 160 = 101
S = 16400
# the utterances' sample counts: full, ragged, under one window (0 frames)
NUM_SAMPLES = [S, 9000, 350]
# fp32 on both sides, summed in other orders. Bins within 70 dB of their
# frame's peak: the port within 1e-4 in log of the host oracle
# ``fbank_numpy`` (float64 FFT of f32 frames; measured 6.1e-5 at most here),
# and within 2e-4 of JAX, whose own XLA products lie up to 1.4e-4 from that
# oracle at these bins. Quieter bins are spectral leakage whose relative
# rounding error is unbounded.
FBANK_ATOL = 1e-4
FBANK_ATOL_JAX = 2e-4
FBANK_LOG_TOL = 5e-4  # ops/front_kernel_checks.py: the goldens' rule
DB70 = 70 * np.log(10) / 10
SPECAUG = {
    # the flagship's recipe (conformer_transducer_librispeech.yaml:35)
    "flagship": "{'W': 80, 'F': 27, 'T': 100, 'num_freq_masks': 2, 'num_time_masks': 2, 'p': 1.0}",
    # adaptive time masks (transformer_librispeech.yaml:27)
    "adaptive": "{'time_warp_W': 0, 'freq_mask_F': 27, 'freq_mask_N': 2, 'time_mask_pm': 0.04, "
    "'time_mask_ps': 0.04}",
    # Switchboard's aliases and a time-mask cap (lstm_specaug_swbd.yaml:31)
    "swbd": "{'time_warp_W': 0, 'freq_mask_F': 18, 'time_mask_T': 70, 'freq_mask_N': 2, "
    "'time_mask_N': 2, 'time_mask_p': 0.2}",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waveforms(seed=0, B=3):
    """int16-scale noise plus two tones per utterance, zero past each count."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 16000.0
    wav = rng.standard_normal((B, S)) * 2000.0
    for b in range(B):
        f1, f2 = rng.uniform(100, 7900, 2)
        wav[b] += 8000 * np.sin(2 * np.pi * f1 * t) + 3000 * np.sin(2 * np.pi * f2 * t)
    ns = np.array(NUM_SAMPLES[:B], np.int32)
    wav[np.arange(S)[None, :] >= ns[:, None]] = 0.0
    return wav.astype(np.float32), ns


def _loud(ref):
    """Bins within 70 dB of their frame's peak."""
    return (ref - ref.max(-1, keepdims=True)) >= -DB70


@pytest.fixture(scope="module")
def jax_fbank():
    wav, ns = _waveforms()
    fused = jax_fbank_fused(jnp.asarray(wav), jnp.asarray(ns))
    pallas = jax_fbank_pallas(jnp.asarray(wav), jnp.asarray(ns), interpret=True)
    return wav, ns, [tuple(np.asarray(a) for a in r) for r in (fused, pallas)]


def test_fbank_matches_jax_fused_and_pallas(jax_fbank):
    wav, ns, refs = jax_fbank
    got, lengths = fbank_fused(torch.from_numpy(wav), torch.from_numpy(ns))
    got, lengths = got.numpy(), lengths.numpy()
    assert got.shape == (3, 101, 80) and got.dtype == np.float32
    np.testing.assert_array_equal(lengths, [101, 54, 0])
    for b, n in enumerate(lengths[:2]):
        oracle = fbank_numpy(wav[b, : ns[b]])
        assert oracle.shape == (n, 80)
        assert np.abs(got[b, :n] - oracle)[_loud(oracle)].max() <= FBANK_ATOL
    for ref, ref_len in refs:
        np.testing.assert_array_equal(lengths, ref_len)
        for b, n in enumerate(lengths):
            assert not got[b, n:].any()  # zeroed tails, exactly
            ok = _loud(ref[b, :n])
            assert n == 0 or ok.mean() > 0.9  # the comparison covers most bins
            assert np.abs(got[b, :n] - ref[b, :n])[ok].max(initial=0.0) <= FBANK_ATOL_JAX



def test_fbank_8khz_matches_jax_fused():
    """8 kHz (window 200, shift 80, a 256-point DFT): the port's plain
    version against JAX ``fbank_fused`` on the CPU."""
    S = 8200
    rng = np.random.default_rng(9)
    t = np.arange(S) / 8000.0
    wav = rng.standard_normal((2, S)) * 2000.0
    for b in range(2):
        f1, f2 = rng.uniform(100, 3900, 2)
        wav[b] += 8000 * np.sin(2 * np.pi * f1 * t) + 3000 * np.sin(2 * np.pi * f2 * t)
    ns = np.array([S, 4321], np.int32)
    wav[np.arange(S)[None, :] >= ns[:, None]] = 0.0
    wav = wav.astype(np.float32)
    ref, ref_len = (np.asarray(a) for a in jax_fbank_fused(jnp.asarray(wav), jnp.asarray(ns), 8000.0))
    got, lengths = fbank_fused(torch.from_numpy(wav), torch.from_numpy(ns), 8000.0)
    got, lengths = got.numpy(), lengths.numpy()
    np.testing.assert_array_equal(lengths, ref_len)
    np.testing.assert_array_equal(lengths, [1 + (S - 200) // 80, 1 + (4321 - 200) // 80])
    assert got.shape == ref.shape == (2, 1 + (S - 200) // 80, 80)
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()
        ok = _loud(ref[b, :n])
        assert ok.mean() > 0.9
        assert np.abs(got[b, :n] - ref[b, :n])[ok].max() <= FBANK_ATOL_JAX


def _rate_inputs(sample_rate):
    """0.3 s of audio and a ragged second utterance of four frames at
    ``sample_rate``: (wav [2, S] f32, num_samples [2] int32, window, shift)."""
    S = int(0.3 * sample_rate)
    window, shift = round(sample_rate * 0.025), round(sample_rate * 0.01)
    rng = np.random.default_rng(int(sample_rate))
    t = np.arange(S) / sample_rate
    wav = rng.standard_normal((2, S)) * 2000.0
    for b in range(2):
        f1, f2 = rng.uniform(100, sample_rate / 2 - 100, 2)
        wav[b] += 8000 * np.sin(2 * np.pi * f1 * t) + 3000 * np.sin(2 * np.pi * f2 * t)
    ns = np.array([S, window + 3 * shift + 1], np.int32)
    wav[np.arange(S)[None, :] >= ns[:, None]] = 0.0
    return wav.astype(np.float32), ns, window, shift


def _rate_parity(sample_rate):
    """``_rate_inputs`` through JAX ``fbank_fused`` and the port's plain
    version on the CPU: (port, JAX, lengths), the lengths checked equal."""
    wav, ns, window, shift = _rate_inputs(sample_rate)
    S = wav.shape[1]
    ref, ref_len = (
        np.asarray(a) for a in jax_fbank_fused(jnp.asarray(wav), jnp.asarray(ns), sample_rate)
    )
    got, lengths = fbank_fused(torch.from_numpy(wav), torch.from_numpy(ns), sample_rate)
    got, lengths = got.numpy(), lengths.numpy()
    np.testing.assert_array_equal(lengths, ref_len)
    np.testing.assert_array_equal(lengths, [1 + (S - window) // shift, 4])
    assert got.shape == ref.shape == (2, 1 + (S - window) // shift, 80)
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()
    return got, ref, lengths


@pytest.mark.parametrize("sample_rate", [22050.0, 44100.0, 48000.0, 96000.0])
def test_fbank_higher_rates_match_jax_fused(sample_rate):
    """22.05 to 96 kHz (1024-, 2048- and 4096-point DFTs; 44.1 kHz with an
    odd shift of 441 samples): the port's plain version against JAX
    ``fbank_fused`` on the CPU, 0.3 s of audio and a ragged second
    utterance of four frames. Both sum a 551- to 2400-sample frame's fp32
    DFT products in other orders; that rounding floor is a share of the
    frame's peak and grows with the frame, so bins near 70 dB down read
    up to ~2.1e-4 apart (22.05 kHz): the goldens' rule, 5e-4 in log on the
    bins within 70 dB of the peak (FBANK_LOG_TOL), bounds them."""
    got, ref, lengths = _rate_parity(sample_rate)
    for b, n in enumerate(lengths):
        ok = _loud(ref[b, :n])
        assert ok.mean() > 0.9
        assert np.abs(got[b, :n] - ref[b, :n])[ok].max() <= FBANK_LOG_TOL


def test_fbank_8192_point_rate_matches_jax_oracle():
    """176.4 kHz (a 4410-sample window: an 8192-point DFT, the kernel's
    largest instance): the port's plain version on ``_rate_inputs`` against
    the JAX package's host oracle ``fbank_numpy`` (numpy's FFT, utterance
    by utterance; JAX's fused path builds and compiles [8192, 4097] DFT
    bases), every bin held to FBANK_LOG_TOL: at this rate ~20 % of the
    bins (the narrow low mel bins, quiet after pre-emphasis) lie more than
    70 dB under their frame's peak, and they agree within the bound too."""
    wav, ns, window, shift = _rate_inputs(176400.0)
    got, lengths = fbank_fused(torch.from_numpy(wav), torch.from_numpy(ns), 176400.0)
    got, lengths = got.numpy(), lengths.numpy()
    np.testing.assert_array_equal(lengths, [1 + (wav.shape[1] - window) // shift, 4])
    assert got.shape == (2, lengths[0], 80)
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()
        ref = fbank_numpy(wav[b, : ns[b]], sample_rate=176400.0)
        assert ref.shape == (n, 80)
        assert np.abs(got[b, :n] - ref).max() <= FBANK_LOG_TOL


@pytest.mark.parametrize("bins", [80, 40])
def test_fbank_matches_kaldi_goldens(bins):
    """The goldens' rule (tests/test_features.py): bins within 70 dB of the
    frame's peak to 5e-4 in log, every bin to 5e-5 of the frame's peak
    energy in linear."""
    g = np.load(os.path.join(os.path.dirname(__file__), "data", "kaldi_feature_goldens.npz"))
    for name in ["noise_16000", "tone_7777", "mix_12345"]:
        wav = g[f"wav_{name}"]
        ref = g[f"fbank{bins}_{name}"]
        got, lengths = fbank_fused(
            torch.from_numpy(wav)[None], torch.tensor([len(wav)], dtype=torch.int32),
            num_mel_bins=bins,
        )
        got = got[0].numpy()
        assert got.shape == ref.shape and int(lengths[0]) == ref.shape[0], name
        assert np.abs(got - ref)[_loud(ref)].max() < 5e-4, name
        rel = np.abs(np.exp(got) - np.exp(ref)) / np.exp(ref).max(axis=1, keepdims=True)
        assert rel.max() < 5e-5, (name, rel.max())


def test_fbank_edge_shapes():
    """S under one window (T = 1, no valid frame), B = 1, S not a multiple
    of the shift: the lengths of JAX's Kaldi frame count, the values of the
    host oracle."""
    from espresso_tpu.features.fbank import num_samples_to_num_frames

    for n, want_T in [(399, 1), (400, 1), (4321, 25)]:
        wav = np.random.default_rng(n).standard_normal((1, n)).astype(np.float32) * 1000
        out, lengths = fbank_fused(torch.from_numpy(wav), torch.tensor([n], dtype=torch.int32))
        want_len = num_samples_to_num_frames(n)
        assert out.shape == (1, want_T, 80) and int(lengths[0]) == want_len
        got = out.numpy()
        assert not got[0, want_len:].any()
        if want_len:
            oracle = fbank_numpy(wav[0])
            assert np.abs(got[0, :want_len] - oracle)[_loud(oracle)].max() <= FBANK_ATOL


def test_device_feature_fn_matches_jax(tmp_path):
    """fbank -> global CMVN (stats from the port's host accumulator, in an
    .npz) -> delta-deltas, against JAX's make_device_feature_fn."""
    wav, ns = _waveforms(seed=1)
    frames, lengths = fbank_fused(torch.from_numpy(wav), torch.from_numpy(ns))
    stats = compute_global_cmvn_stats(frames[b, :n] for b, n in enumerate(lengths.tolist()))
    path = str(tmp_path / "cmvn.npz")
    np.savez(path, **stats)
    jcfg, pcfg = JaxConfig(), EspressoConfig()
    for cfg in (jcfg, pcfg):
        cfg.dataset.feature_type = "device_fbank"
        cfg.dataset.global_cmvn_stats_path = path
        cfg.dataset.delta_deltas = True
    mb = {"src_waveforms": wav, "num_samples": ns, "target": np.zeros((3, 2), np.int32)}
    got = make_device_feature_fn(pcfg)({k: torch.from_numpy(v) for k, v in mb.items()})
    want = jax_feature_fn(jcfg)({k: jnp.asarray(v) for k, v in mb.items()})
    assert set(got) == set(want) == {"src_frames", "src_lengths", "target"}
    np.testing.assert_array_equal(got["src_lengths"].numpy(), np.asarray(want["src_lengths"]))
    g, w = got["src_frames"].numpy(), np.asarray(want["src_frames"])
    assert g.shape == w.shape == (3, 101, 240)
    # the static coefficients: the fbank's bound on loud bins, over the std
    jf, _ = jax_fbank_fused(jnp.asarray(wav), jnp.asarray(ns))
    loud = _loud(np.asarray(jf))
    assert np.all(np.abs(g[..., :80] - w[..., :80])[loud] <= FBANK_ATOL_JAX / np.broadcast_to(
        stats["std"], loud.shape)[loud])
    # CMVN and the deltas on the port's own fbank frames: JAX's arithmetic
    from espresso_tpu.features.transforms import delta_deltas as jax_delta_deltas

    want_own = np.asarray(jax_delta_deltas((jnp.asarray(frames.numpy()) - stats["mean"])
                                           / stats["std"]))
    np.testing.assert_allclose(g, want_own, rtol=1e-5, atol=1e-5)
    # the CMVN object and utterance CMVN agree with their JAX twins
    from espresso_tpu.features.cmvn import GlobalCMVN as JaxGlobalCMVN
    from espresso_tpu.features.cmvn import utterance_cmvn as jax_utterance_cmvn

    x = frames.numpy()
    np.testing.assert_allclose(
        GlobalCMVN(path)(frames).numpy(), np.asarray(JaxGlobalCMVN(path)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6,
    )
    # the per-utterance mean sums ~100 frames of log-mel values ~10 in f32,
    # in another order on each side: the sum's ulp, ~1e-4, over the count
    for norm_vars in (False, True):
        np.testing.assert_allclose(
            utterance_cmvn(frames, lengths, norm_vars=norm_vars).numpy(),
            np.asarray(jax_utterance_cmvn(jnp.asarray(x), jnp.asarray(lengths.numpy()),
                                          norm_vars=norm_vars)),
            rtol=1e-5, atol=2e-4,
        )


def test_waveform_feature_type_passes_samples_through():
    cfg = EspressoConfig()
    cfg.dataset.feature_type = "waveform"
    wav, ns = _waveforms(seed=2)
    out = make_device_feature_fn(cfg)({"src_waveforms": torch.from_numpy(wav),
                                       "num_samples": torch.from_numpy(ns)})
    assert set(out) == {"src_frames", "src_lengths"}
    assert torch.equal(out["src_frames"], torch.from_numpy(wav))
    frames = {"src_frames": torch.zeros(1, 2, 80), "src_lengths": torch.ones(1)}
    assert make_device_feature_fn(cfg)(frames) is frames


def _jax_draws(key, B, F, cfg):
    """JAX's own draws, replayed from the key splits of specaugment.py:62-116
    and :119-161."""
    k_f, k_t, k_w = jax.random.split(key, 3)
    d = {}
    if cfg.time_warp_w > 0:
        k1, k2 = jax.random.split(k_w)
        W = cfg.time_warp_w
        d["warp_u"] = jax.random.uniform(k1, (B,))
        d["warp_w"] = jax.random.randint(k2, (B,), -W, W + 1)
    if cfg.num_freq_masks > 0 and cfg.freq_mask_width > 0:
        kf1, kf2 = jax.random.split(k_f)
        n = cfg.num_freq_masks
        d["freq_widths"] = jax.random.randint(kf1, (B, n), 0, cfg.freq_mask_width + 1)
        d["freq_starts"] = jax.random.randint(kf2, (B, n), 0, max(F - 1, 1))
    n_cap = cfg.max_time_masks if cfg.time_mask_pm is not None else cfg.num_time_masks
    if n_cap > 0:
        kt1, kt2, _ = jax.random.split(k_t, 3)
        d["time_u"] = jax.random.uniform(kt1, (B, n_cap))
        d["time_starts_u"] = jax.random.uniform(kt2, (B, n_cap))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(SPECAUG))
def test_specaugment_apply_matches_jax_given_its_draws(name):
    """Equal to JAX given JAX's draws. The flagship's W=80 warp applies only
    where len > 161: lengths 240 and 200 are warped, 120 is not."""
    B, T, F = 3, 240, 80
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    lengths = np.array([240, 200, 120], np.int32)
    jcfg = jax_specaugment.SpecAugmentConfig.from_string(SPECAUG[name])
    pcfg = SpecAugmentConfig.from_string(SPECAUG[name])
    assert jcfg.__dict__ == pcfg.__dict__
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_specaugment.apply_specaugment(
        jnp.asarray(x), jnp.asarray(lengths), key, jcfg))
    got = apply_specaugment(torch.from_numpy(x), torch.from_numpy(lengths),
                            _jax_draws(key, B, F, pcfg), pcfg).numpy()
    # the warp's re-sampling is the same f32 arithmetic on both sides
    np.testing.assert_array_equal(got, want)
    if name == "flagship":  # the warp moved the frames of a warped utterance
        assert not np.array_equal(want[0], x[0])


def test_specaugment_draws_follow_jax_bounds_and_distributions():
    cfg = SpecAugmentConfig.from_string(SPECAUG["flagship"])
    B, F = 4096, 80
    g = torch.Generator().manual_seed(0)
    d = draw_specaugment(B, F, cfg, g, "cpu")
    assert d["freq_widths"].shape == (B, 2) and d["time_u"].shape == (B, 2)
    # randint bounds: widths in [0, F], starts in [0, F-2], warp in [-W, W]
    fw, fs, ww = d["freq_widths"], d["freq_starts"], d["warp_w"]
    assert int(fw.min()) == 0 and int(fw.max()) == 27
    assert int(fs.min()) == 0 and int(fs.max()) == F - 2
    assert int(ww.min()) == -80 and int(ww.max()) == 80
    for k in ("warp_u", "time_u", "time_starts_u"):
        u = d[k]
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02  # 4096 draws: sigma ~0.005
    # uniform integers: each value's share near 1/count
    share = torch.bincount(fw.reshape(-1), minlength=28).float() / fw.numel()
    assert float((share - 1 / 28).abs().max()) < 0.015
    # the adaptive count's static cap sets the time draws' width
    d = draw_specaugment(2, F, SpecAugmentConfig.from_string(SPECAUG["adaptive"]), g, "cpu")
    assert d["time_u"].shape == (2, 20) and "warp_u" not in d


class _Dictionary:
    def pad(self):
        return 1

    def blank(self):
        return 0


def _tiny_step(feature_cfg=None):
    """A 2-layer Conformer-Transducer (D=64, H=2, V=32) from seed 0, fp32,
    dropout 0, with its train step."""
    from espresso_tpu_torch.criterions import TransducerCriterion
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
    from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
    from espresso_tpu_torch.train.trainer import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    torch.manual_seed(0)
    enc = SpeechTransformerConfig(
        encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=64, encoder_ffn_dim=128, encoder_layers=2, encoder_heads=2,
        depthwise_conv_kernel_size=7, dropout=0.0,
    )
    model = TransducerModel(TransducerConfig(
        feat_dim=80, vocab_size=32, encoder=enc, pred_embed_dim=64, pred_hidden_size=64,
        pred_layers=1, pred_dropout=0.0, joint_dim=64,
    ))
    cfg = EspressoConfig()
    cfg.common.dtype = "float32"
    if feature_cfg:
        feature_cfg(cfg)
    optimizer, _ = build_optimizer(cfg)
    state = create_train_state(model, optimizer, cfg)
    return model, state, make_train_step(model, TransducerCriterion(cfg.criterion, _Dictionary()),
                                         optimizer, cfg)


def _pcm_batch():
    wav, ns = _waveforms(seed=4, B=2)
    rng = np.random.default_rng(4)
    batch = {
        "src_waveforms": wav, "num_samples": ns,
        "prev_output_tokens": rng.integers(4, 32, (2, 4)).astype(np.int32),
        "target": rng.integers(4, 32, (2, 3)).astype(np.int32),
        "tgt_lengths": np.array([3, 2], np.int32),
        "weight": np.ones(2, np.float32),
    }
    return {k: torch.from_numpy(v)[None] for k, v in batch.items()}  # one microbatch


def test_step_fed_pcm_equals_step_fed_the_fronts_frames():
    """SpecAugment off: the step runs the front on the PCM batch itself,
    and its loss, gradients and update equal those of a step fed the
    front's frames."""
    pcm = _pcm_batch()
    mb = make_device_feature_fn(EspressoConfig())({k: v[0] for k, v in pcm.items()})
    frames = {k: v[None] for k, v in mb.items()}
    assert "src_waveforms" not in frames and frames["src_frames"].shape == (1, 2, 101, 80)
    results = []
    for batch in (pcm, frames):
        model, state, step = _tiny_step()
        state, metrics = step(state, batch)
        results.append((state, metrics))
    (s1, m1), (s2, m2) = results
    assert torch.isfinite(m1["loss"]) and m1["overflow"].item() == 0.0
    for k in ("loss", "gnorm", "sample_size"):
        assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(s1.grads, s2.grads) and torch.equal(s1.params, s2.params)


def test_step_applies_specaugment_from_its_generator():
    """With the flagship's SpecAugment string the step draws its masks from
    the generator it is given: the same seed gives the same step, another
    seed another loss."""
    def cfg_fn(cfg):
        cfg.dataset.specaugment_config = SPECAUG["flagship"]

    pcm = _pcm_batch()
    losses = []
    for seed in (0, 0, 1):
        _, state, step = _tiny_step(cfg_fn)
        _, metrics = step(state, pcm, torch.Generator().manual_seed(seed))
        losses.append(metrics["loss"].item())
    _, state, step = _tiny_step()
    _, plain = step(state, pcm)
    assert losses[0] == losses[1] != losses[2]
    assert plain["loss"].item() not in losses
