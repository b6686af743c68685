"""The port's recipe entry points held against the JAX package on the CPU.

WER scoring, BLEU/chrF, the metrics aggregator and progress lines, the
heartbeat, the data-preparation CLIs and the saved-model-config restore give
JAX's results (strings and numbers equal, files byte for byte); then the
recipe end to end on the port for each model family: prep -> the train CLI
with WER validation -> ``speech_recognize`` -> the result files, and the
hub's ``transcribe`` gives the CLI's hypotheses (the transducer's through
checkpoint averaging; the attention encoder-decoder's files, alone and
with an LM, byte for byte against JAX's CLI). Everything runs on the CPU
(``device="cpu"``), f32.
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

# speech_conv_lstm_wsj (lstm_wsj.yaml's criterion) narrowed: a 2-layer frontend
# (4x subsampling), one bi-LSTM layer of 16, two decoder layers of 16,
# attention 12, scheduled sampling on
LSTM_TINY = [
    "dataset.max_tokens=400", "dataset.num_batch_buckets=1", "dataset.feat_dim=12",
    "criterion.name=label_smoothed_cross_entropy_v2", "criterion.label_smoothing=0.05",
    "criterion.smoothing_type=temporal", "model.name=speech_conv_lstm_wsj", "model.conv_channels=(4,8)",
    "model.conv_kernel_sizes=((3,3),(3,3))", "model.conv_strides=((2,2),(2,2))",
    "model.encoder_hidden_size=16", "model.encoder_layers=1", "model.decoder_embed_dim=8",
    "model.decoder_hidden_size=16", "model.decoder_out_embed_dim=24", "model.decoder_layers=2",
    "model.attention_dim=12", "optimization.lr=0.005", "optimization.clip_norm=2.0",
    "common.dtype=float32", "task.scheduled_sampling=true", "task.scheduled_sampling_probs=0.8",
]
# speech_transformer_wsj (transformer_librispeech.yaml's criterion and
# relative positions) narrowed: a 2-layer frontend (4x subsampling), one
# encoder layer and two decoder layers of 16, ffn 32, 2 heads
TRANSFORMER_TINY = [
    "dataset.max_tokens=400", "dataset.num_batch_buckets=1", "dataset.feat_dim=12",
    "criterion.name=label_smoothed_cross_entropy_v2", "criterion.label_smoothing=0.1",
    "model.name=speech_transformer_wsj", "model.encoder_pos_type=relative", "model.conv_channels=(4,8)",
    "model.conv_kernel_sizes=((3,3),(3,3))", "model.conv_strides=((2,2),(2,2))",
    "model.encoder_embed_dim=16", "model.encoder_ffn_dim=32", "model.encoder_layers=1",
    "model.encoder_heads=2", "model.decoder_embed_dim=16", "model.decoder_ffn_dim=32",
    "model.decoder_layers=2", "model.decoder_heads=2", "optimization.lr=0.005",
    "optimization.clip_norm=2.0", "common.dtype=float32",
]
# transformer_ctc_librispeech (transformer_ctc_librispeech.yaml's criterion
# and relative positions) narrowed: a 2-layer frontend (4x subsampling), one
# encoder layer of 16, ffn 32, 2 heads
CTC_TINY = [
    "dataset.max_tokens=400", "dataset.num_batch_buckets=1", "dataset.feat_dim=12", "criterion.name=ctc_loss",
    "model.name=transformer_ctc_librispeech", "model.encoder.encoder_pos_type=relative",
    "model.encoder.conv_channels=(4,8)", "model.encoder.conv_kernel_sizes=((3,3),(3,3))",
    "model.encoder.conv_strides=((2,2),(2,2))", "model.encoder.encoder_embed_dim=16",
    "model.encoder.encoder_ffn_dim=32", "model.encoder.encoder_layers=1", "model.encoder.encoder_heads=2",
    "optimization.lr=0.005", "optimization.clip_norm=2.0", "common.dtype=float32",
]
# what each family's speech_recognize and hub take beside the data, the
# checkpoint directory and the feature width: the transducer decodes the
# average of its 2 epoch checkpoints at beam 2, the encoder-decoder its
# checkpoint_last at beam 3 with eos_factor, CTC its checkpoint_last with
# the prefix beam search at beam 3
DECODE = {
    "transducer": {"checkpoint.restore_file": "checkpoint_avg", "generation.beam": 2},
    "lstm": {"dataset.max_tokens": 100000, "dataset.num_batch_buckets": 1, "generation.beam": 3,
             "generation.eos_factor": 1.2, "generation.max_len_b": 12},
    "transformer": {"dataset.max_tokens": 100000, "dataset.num_batch_buckets": 1, "generation.beam": 3,
                    "generation.eos_factor": 1.5, "generation.max_len_b": 12},
    "transformer_ctc": {"dataset.max_tokens": 100000, "dataset.num_batch_buckets": 1, "generation.beam": 3},
}
# the encoder-decoders' and CTC's train arguments
ENC_DEC_TINY = {"lstm": LSTM_TINY, "transformer": TRANSFORMER_TINY, "transformer_ctc": CTC_TINY}


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
    # binarize is ported (its parity: tests/test_torch_lm_train.py)
    with pytest.raises(NotImplementedError, match="queue A"):
        port_prep.estimate_state_prior([])


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


def _write_lm(d):
    """A seeded LSTM LM over make_corpus's 11 units in ``d``/lm, as the
    train CLI writes one (model_cfg.json and checkpoint_last)."""
    from espresso_tpu_torch.bridge import flax_paths, to_flax_layout
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
    from espresso_tpu_torch.train import checkpoint as ckpt

    torch.manual_seed(0)
    lm_cfg = LSTMLMConfig(vocab_size=11, embed_dim=8, hidden_size=12, out_embed_dim=12, num_layers=2)
    lm = LSTMLanguageModel(lm_cfg)
    named, params = dict(lm.named_parameters()), {}
    for name, path in flax_paths(lm)[0].items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(to_flax_layout(path[-1], named[name].detach().numpy()))
    os.makedirs(f"{d}/lm")
    with open(f"{d}/lm/model_cfg.json", "w") as f:
        json.dump({"model_name": "LSTMLanguageModel", "name": "lstm_lm_espresso",
                   "config": port_config.config_to_dict(lm_cfg)}, f)
    ckpt.save_checkpoint_state(f"{d}/lm/checkpoint_last", ckpt.flatten_tree({"params": params}), {})


def _jax_recognizer(monkeypatch, raw):
    """JAX's speech_recognize reading the port's checkpoint files through
    the port's reader (its own reads orbax directories; an orbax write and
    restore here cost ~15 s), with a train state of the checkpoint's tree
    in place of the one it inits for the tree's structure alone."""
    from espresso_tpu.cli import speech_recognize as jax_rec
    from espresso_tpu.models.lstm_lm import LSTMLanguageModel as JaxLM
    from espresso_tpu.models.lstm_lm import LSTMLMConfig as JaxLMConfig
    from espresso_tpu.train import checkpoint as jax_ckpt
    from espresso_tpu.train.trainer import TrainState
    from espresso_tpu_torch.train import checkpoint as ckpt

    def jax_lm(ckpt_dir):  # JAX's _load_lm_checkpoint, its restore the port's reader
        with open(os.path.join(ckpt_dir, "model_cfg.json")) as f:
            cfg = JaxLMConfig(**json.load(f)["config"])
        return JaxLM(cfg), {"params": ckpt.load_raw_checkpoint(f"{ckpt_dir}/checkpoint_last")["params"]}, cfg

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    monkeypatch.setattr(jax_ckpt, "load_raw_checkpoint", ckpt.load_raw_checkpoint)
    monkeypatch.setattr(jax_rec, "_load_lm_checkpoint", jax_lm)
    monkeypatch.setattr(jax_rec, "create_train_state", lambda *a, **kw: TrainState(
        step=0, params=raw["params"], batch_stats=raw["batch_stats"], opt_state=None))
    return jax_rec.main


@pytest.mark.parametrize("family", ["transducer", "lstm", "transformer", "transformer_ctc"])
def test_recipe_end_to_end_on_the_port(tmp_path, monkeypatch, family):
    """prep (asr_prep_json from scp and text files) -> the train CLI with
    WER validation -> speech_recognize -> the four result files; the hub's
    transcribe on two utterances gives the CLI's hypotheses. The conformer
    transducer trains 2 epochs and decodes from the average of its 2 epoch
    checkpoints. The attention encoder-decoders (``LSTM_TINY`` with
    scheduled sampling, ``TRANSFORMER_TINY``) and CTC (``CTC_TINY``, the
    prefix beam search, which takes the LM unread) train 2 updates and
    decode alone and fused with an LSTM LM; JAX's speech_recognize
    (``_jax_recognizer``) on the same checkpoints writes the same four
    files byte for byte and returns the same numbers."""
    from espresso_tpu_torch import hub
    from espresso_tpu_torch.cli import average_checkpoints, speech_recognize, train
    from espresso_tpu_torch.train import checkpoint as ckpt

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
    args = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt"]
    if family == "transducer":
        stats = train.main(args + TINY + ["optimization.max_epoch=2"], device="cpu")
        for name in ("checkpoint1", "checkpoint2", "checkpoint_best", "checkpoint_last", "model_cfg.json"):
            assert os.path.exists(f"{d}/ckpt/{name}"), name
        average_checkpoints.main(["--inputs", f"{d}/ckpt", "--num-epoch-checkpoints", "2",
                                  "--output", f"{d}/ckpt/checkpoint_avg"])
        lm_runs = [{}]
    else:
        stats = train.main(args + ENC_DEC_TINY[family] + ["optimization.max_update=2"], device="cpu")
        raw = ckpt.load_raw_checkpoint(f"{d}/ckpt/checkpoint_last")
        assert int(raw["step"]) == 2
        _write_lm(d)
        jax_main = _jax_recognizer(monkeypatch, raw)
        lm_runs = [{}, {"generation.lm_path": f"{d}/lm", "generation.lm_weight": 0.4}]
    assert np.isfinite(stats["loss"]) and "valid_wer" in stats and "valid_cer" in stats
    common = {"dataset.feat_dim": 12, "common.dtype": "float32", **DECODE[family]}
    files = ["aligned_results.txt", "cer", "decoded_results.txt", "wer"]
    for i, lm in enumerate(lm_runs):
        dec = args + [f"{k}={v}" for k, v in {**common, **lm}.items()]
        res = speech_recognize.main(dec + [f"generation.results_path={d}/dec{i}"], device="cpu")
        assert res["num_utts"] == 4 and 0.0 <= res["wer"]
        assert sorted(os.listdir(f"{d}/dec{i}")) == files
        assert open(f"{d}/dec{i}/wer").read().startswith("WER: ")
        if family != "transducer":
            assert jax_main(dec + [f"generation.results_path={d}/jax{i}"]) == res, lm
            for name in files:
                assert open(f"{d}/dec{i}/{name}", "rb").read() == open(f"{d}/jax{i}/{name}", "rb").read(), (lm, name)
    cli = dict(line.rstrip("\n").partition(" ")[::2] for line in open(f"{d}/dec{i}/decoded_results.txt"))
    assert any(cli.values())  # the hypotheses are not all empty
    test = json.load(open(f"{d}/test.json"))
    utts = sorted(test)[:2]
    asr = hub.from_pretrained(f"{d}/ckpt", data_dir=d, beam=common["generation.beam"], device="cpu",
                              **{**common, **lm_runs[-1]})
    assert asr.transcribe([test[u]["feat"] for u in utts]) == [cli[u] for u in utts]
