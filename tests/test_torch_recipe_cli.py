"""The port's recipe entry points held against the JAX package on the CPU.

WER scoring, BLEU/chrF, the metrics aggregator and progress lines, the
heartbeat, the data-preparation CLIs and the saved-model-config restore give
JAX's results (strings and numbers equal, files byte for byte); then the
recipe end to end on the port alone: prep -> the train CLI for 2 epochs
with WER validation -> checkpoint averaging -> ``speech_recognize`` at
beam 2 -> the ``wer`` file, and the hub's ``transcribe`` gives the CLI's
hypotheses. Everything runs on the CPU (``device="cpu"``), f32.
"""

import contextlib
import io
import json
import logging
import os
import shutil
import time
import wave

import numpy as np
import pytest
import torch

from espresso_tpu import config as jax_config
from espresso_tpu.cli import prep as jax_prep
from espresso_tpu.tools import scoring as jax_scoring
from espresso_tpu.tools import wer as jax_wer
from espresso_tpu.train import metrics as jax_metrics
from espresso_tpu_torch import config as port_config
from espresso_tpu_torch.cli import prep as port_prep
from espresso_tpu_torch.tools import scoring as port_scoring
from espresso_tpu_torch.tools import wer as port_wer
from espresso_tpu_torch.train import metrics as port_metrics
from espresso_tpu_torch.train.heartbeat import HeartbeatMonitor
from utils import make_corpus

# a tiny conformer transducer on make_corpus's 12-dim features
TINY = [
    "dataset.max_tokens=800", "dataset.num_batch_buckets=1", "dataset.required_batch_size_multiple=2",
    "dataset.feat_dim=12", "criterion.name=transducer_loss", "model.name=speech_transformer_transducer",
    "model.encoder.encoder_embed_dim=32", "model.encoder.encoder_ffn_dim=64",
    "model.encoder.encoder_layers=1", "model.encoder.encoder_heads=2",
    "model.encoder.conv_channels=(4,4,8,8)", "model.encoder.depthwise_conv_kernel_size=7",
    "model.encoder.dropout=0.0", "model.pred_embed_dim=16", "model.pred_hidden_size=16",
    "model.pred_dropout=0.0", "model.joint_dim=16", "optimization.lr=0.005",
    "optimization.clip_norm=2.0", "common.log_interval=2", "common.dtype=float32",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sentences(rng, n, words):
    """Seeded ref/hyp pairs: each hypothesis is its reference with words
    substituted, inserted and deleted at random (some left equal)."""
    pairs = []
    for i in range(n):
        ref = list(rng.choice(words, size=int(rng.integers(0, 8))))
        hyp = []
        for w in ref:
            r = rng.random()
            if r < 0.15:
                continue  # deletion
            hyp.append(str(rng.choice(words)) if r < 0.3 else w)
            if rng.random() < 0.1:
                hyp.append(str(rng.choice(words)))  # insertion
        pairs.append((f"utt{i:03d}", " ".join(ref), " ".join(hyp)))
    return pairs


def test_wer_scorer_matches_jax(tmp_path):
    """Scorer, edit_distance and aligned_print: every count, rate and
    string equal to JAX's, with and without an output filter (a
    substitution rule and a bare token to delete)."""
    rng = np.random.default_rng(0)
    words = ["the", "cat", "sat", "on", "mat", "uh", "dog", "a", "ran", "<unk>"]
    pairs = _sentences(rng, 40, words)
    filt = tmp_path / "filter.txt"
    filt.write_text("# comment\ns/dog/cat/g\nuh\n")
    for wer_filter in (None, str(filt)):
        scorers = [m.Scorer(None, wer_filter) for m in (jax_wer, port_wer)]
        for s in scorers:
            for utt, ref, hyp in pairs:
                s.add_prediction(utt, hyp)
                s.add_evaluation(utt, ref, hyp)
        j, p = scorers
        assert p.results == j.results and p.aligned_results == j.aligned_results
        assert p.char_counter == j.char_counter and p.word_counter == j.word_counter
        assert (p.wer(), p.cer(), p.result_string(), p.num_utts) == (j.wer(), j.cer(), j.result_string(), j.num_utts)
        for f in ("tot_word_error", "tot_word_count", "tot_char_error", "tot_char_count"):
            assert getattr(p, f)() == getattr(j, f)()
    for _, ref, hyp in pairs[:10]:
        r, h = ref.split(), hyp.split()
        (jd, jc), (pd, pc) = jax_wer.edit_distance(r, h), port_wer.edit_distance(r, h)
        assert np.array_equal(jd, pd) and jc == pc
        assert port_wer.aligned_print(r, h, pc["steps"]) == jax_wer.aligned_print(r, h, jc["steps"])


def test_bleu_and_chrf_match_jax():
    rng = np.random.default_rng(1)
    pairs = _sentences(rng, 20, ["a", "b", "c", "d", "e", "f"])
    jb, pb = jax_scoring.BleuScorer(), port_scoring.BleuScorer()
    jc, pc = jax_scoring.ChrFScorer(), port_scoring.ChrFScorer()
    for _, ref, hyp in pairs:
        jb.add(ref.split(), hyp.split())
        pb.add(ref.split(), hyp.split())
        jc.add(ref, hyp)
        pc.add(ref, hyp)
        assert port_scoring.sentence_bleu(ref.split(), hyp.split()) == jax_scoring.sentence_bleu(
            ref.split(), hyp.split())
    assert (pb.score(), pb.result_string()) == (jb.score(), jb.result_string())
    assert (pc.score(), pc.result_string()) == (jc.score(), jc.result_string())


def test_metrics_and_progress_lines_match_jax(caplog, monkeypatch):
    """MetricsAggregator.smoothed() on the same stats (per update and
    pre-summed), the simple and json progress lines and the epoch line, the
    same as JAX's; a sink whose package is absent is skipped with a
    warning."""
    monkeypatch.setattr(jax_metrics.time, "perf_counter", lambda: 100.0)
    monkeypatch.setattr(port_metrics.time, "perf_counter", lambda: 100.0)
    rng = np.random.default_rng(2)
    stats = [{"loss": float(rng.uniform(10, 50)), "sample_size": float(rng.integers(5, 40)),
              "nll_loss": float(rng.uniform(1, 9)), "ntokens": float(rng.integers(5, 40)),
              "gnorm": float(rng.uniform(0, 3)), "overflow": float(rng.integers(0, 2)),
              "wer": float(rng.integers(0, 9)), "word_count": 10.0, "cer": 3.0, "char_count": 30.0}
             for _ in range(5)]
    aggs = []
    for m in (jax_metrics, port_metrics):
        a, b = m.MetricsAggregator(), m.MetricsAggregator()
        for s in stats:
            a.update(s)
        b.update_sums({k: sum(s[k] for s in stats) for k in stats[0]}, len(stats))
        aggs.append((a.smoothed(), b.smoothed()))
    assert aggs[0] == aggs[1]
    lines = []
    for m in (jax_metrics, port_metrics):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for fmt in ("simple", "json"):
                logger = m.ProgressLogger(2, fmt, tag="train")
                logger.log(aggs[0][0], 7, 3)
                logger.print_epoch(aggs[0][1], 3)
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and len(lines[0]) == 4
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        port_metrics.ProgressLogger(wandb_project="p", aim_repo="r")
    assert any("wandb not available" in r.getMessage() for r in caplog.records)
    assert any("aim not available" in r.getMessage() for r in caplog.records)


def test_heartbeat_fires_on_a_stall_and_not_while_pinged():
    fired = []
    hb = HeartbeatMonitor(0.5, on_timeout=fired.append, poll_interval=0.02).start()
    for _ in range(10):
        time.sleep(0.05)
        hb.ping()
    assert not fired
    time.sleep(1.2)
    hb.stop()
    assert fired == [0.5] and hb.fired
    assert not HeartbeatMonitor(0).start().enabled


def _write_wav(path, n, rate=16000, seed=0):
    pcm = (np.random.default_rng(seed).standard_normal(n) * 3000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _run(cmd, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cmd(argv)
    return out.getvalue()


def test_prep_matches_jax(tmp_path):
    """asr_prep_json, text2token, text2vocabulary (with a cutoff, a size
    and OOV rates, and from a given vocab), compute_cmvn over make_corpus's
    features, wav2num_frames and compute_wer: byte-equal files and output."""
    d = tmp_path
    make_corpus(str(d), "train", num_utts=6, feat_dim=12, seed=0)
    manifest = json.loads((d / "train.json").read_text())
    for i, u in enumerate(manifest):
        _write_wav(d / f"{u}.wav", 4000 + 321 * i, seed=i)
    (d / "wav.scp").write_text("".join(f"{u} {d / u}.wav\n" for u in manifest))
    (d / "text").write_text("".join(f"{u} {e['text']}\n" for u, e in manifest.items()))
    (d / "utt2num_frames").write_text("".join(f"{u} {e['utt2num_frames']}\n" for u, e in manifest.items()))
    (d / "feats.scp").write_text("".join(f"{u} {e['feat']}\n" for u, e in manifest.items()))
    words = " ".join(e["text"] for e in manifest.values()).split()
    (d / "vocab").write_text("".join(f"{w}\n" for w in sorted(set(words))[:5]))
    (d / "hyp").write_text("".join(f"{u} {e['text'][::-1]}\n" for u, e in manifest.items()))
    for name, mod in (("jax", jax_prep), ("port", port_prep)):
        mod.asr_prep_json(["--wave-files", str(d / "wav.scp"), "--text-files", str(d / "text"),
                           "--utt2num-frames-files", str(d / "utt2num_frames"), "--output",
                           str(d / f"{name}.json")])
        mod.compute_cmvn(["--feats-scp", str(d / "feats.scp"), "--output", str(d / f"{name}_f.npz")])
        mod.compute_cmvn(["--manifest", str(d / "train.json"), "--output", str(d / f"{name}_m.npz")])
    assert (d / "jax.json").read_bytes() == (d / "port.json").read_bytes()
    for k in ("f", "m"):
        j, p = np.load(d / f"jax_{k}.npz"), np.load(d / f"port_{k}.npz")
        assert j.files == p.files and all(np.array_equal(j[f], p[f]) and j[f].dtype == p[f].dtype for f in j.files)
    calls = [
        ("text2token", ["--skip-ncols", "1", str(d / "text")]),
        ("text2vocabulary", ["--skip-ncols", "1", "--vocabsize", "7", "--cutoff", "2",
                             "--valid-text", str(d / "text"), str(d / "text")]),
        ("text2vocabulary", ["--skip-ncols", "1", "--vocab", str(d / "vocab"), str(d / "text")]),
        ("wav2num_frames", [str(d / "wav.scp")]),
        ("compute_wer", [str(d / "text"), str(d / "hyp")]),
    ]
    for cmd, argv in calls:
        want = _run(getattr(jax_prep, cmd), argv)
        assert _run(getattr(port_prep, cmd), argv) == want and want, cmd
    for cmd in ("binarize", "estimate_state_prior"):
        with pytest.raises(NotImplementedError, match="queue A"):
            getattr(port_prep, cmd)([])


@pytest.mark.parametrize("overrides", [[], ["model.encoder.encoder_layers=3", "model.joint_dim=24"],
                                       ["model.name=speech_transformer_transducer",
                                        "criterion.name=transducer_loss"]])
def test_saved_model_cfg_resolves_as_jax_does(tmp_path, monkeypatch, overrides):
    """One model_cfg.json written by the port's train CLI: JAX's
    apply_saved_model_cfg and the port's resolve the same model section and
    criterion, with and without model.* overrides; the section builds the
    same model config in both packages."""
    from espresso_tpu.tasks import setup_task as jax_setup_task

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    from espresso_tpu_torch.cli.train import write_model_cfg
    from espresso_tpu_torch.tasks import setup_task as port_setup_task

    d = str(tmp_path)
    make_corpus(d, "train", num_utts=2, feat_dim=12, seed=0)
    train_argv = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt"] + TINY
    cfg = port_config.parse_config(train_argv)
    task = port_setup_task(cfg)
    model = task.build_model(device="cpu")
    write_model_cfg(cfg.checkpoint.save_dir, model, cfg, task.model_cfg)
    argv = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt", "dataset.feat_dim=12"] + overrides
    jcfg = jax_config.apply_saved_model_cfg(jax_config.parse_config(argv), argv)
    pcfg = port_config.apply_saved_model_cfg(port_config.parse_config(argv), argv)
    assert pcfg.model == jcfg.model and pcfg.criterion.name == jcfg.criterion.name == "transducer_loss"
    jt, pt = jax_setup_task(jcfg), port_setup_task(pcfg)
    jt.load_dataset("train"), pt.load_dataset("train")
    jt.build_model()
    assert jax_config.config_to_dict(jt.model_cfg) == port_config.config_to_dict(pt.build_model_config()[1])


def test_recipe_end_to_end_on_the_port(tmp_path):
    """prep (asr_prep_json from scp and text files) -> train 2 epochs with
    WER validation -> average the 2 epoch checkpoints -> speech_recognize at
    beam 2 from checkpoint_avg -> the four result files; the hub's
    transcribe on two utterances gives the CLI's hypotheses."""
    from espresso_tpu_torch import hub
    from espresso_tpu_torch.cli import average_checkpoints, speech_recognize, train

    d = str(tmp_path)
    for split, n, seed in (("train", 12, 0), ("valid", 4, 1)):
        make_corpus(d, split, num_utts=n, feat_dim=12, seed=seed, max_words=3)
        manifest = json.load(open(f"{d}/{split}.json"))
        for name, key in (("feats.scp", "feat"), ("text", "text"), ("utt2num_frames", "utt2num_frames")):
            with open(f"{d}/{split}.{name}", "w") as f:
                f.writelines(f"{u} {e[key]}\n" for u, e in manifest.items())
        port_prep.main(["asr_prep_json", "--feat-files", f"{d}/{split}.feats.scp", "--text-files",
                        f"{d}/{split}.text", "--utt2num-frames-files", f"{d}/{split}.utt2num_frames",
                        "--output", f"{d}/{split}.json"])
    shutil.copy(f"{d}/valid.json", f"{d}/test.json")
    args = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt"] + TINY
    stats = train.main(args + ["optimization.max_epoch=2"], device="cpu")
    assert np.isfinite(stats["loss"]) and "valid_wer" in stats and "valid_cer" in stats
    for name in ("checkpoint1", "checkpoint2", "checkpoint_best", "checkpoint_last", "model_cfg.json"):
        assert os.path.exists(f"{d}/ckpt/{name}"), name
    average_checkpoints.main(["--inputs", f"{d}/ckpt", "--num-epoch-checkpoints", "2",
                              "--output", f"{d}/ckpt/checkpoint_avg"])
    dec = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt", "dataset.feat_dim=12",
           "common.dtype=float32", "checkpoint.restore_file=checkpoint_avg", "generation.beam=2",
           f"generation.results_path={d}/dec"]
    res = speech_recognize.main(dec, device="cpu")
    assert res["num_utts"] == 4 and 0.0 <= res["wer"]
    assert sorted(os.listdir(f"{d}/dec")) == ["aligned_results.txt", "cer", "decoded_results.txt", "wer"]
    assert open(f"{d}/dec/wer").read().startswith("WER: ")
    cli = dict(line.rstrip("\n").partition(" ")[::2] for line in open(f"{d}/dec/decoded_results.txt"))
    test = json.load(open(f"{d}/test.json"))
    utts = sorted(test)[:2]
    asr = hub.from_pretrained(f"{d}/ckpt", data_dir=d, beam=2, device="cpu", **{
        "checkpoint.restore_file": "checkpoint_avg", "dataset.feat_dim": 12, "common.dtype": "float32"})
    assert asr.transcribe([test[u]["feat"] for u in utts]) == [cli[u] for u in utts]
