"""The port's checkpoints and the train and decode CLIs around them, held
against the JAX package on the CPU.

* The save policy leaves the same checkpoint names on disk as JAX's
  ``CheckpointManager`` after each call of a scripted sequence (JAX's
  array writes replaced in the test by making the directory).
* ``average_checkpoints`` gives JAX's averaged params bit for bit.
* A train run stopped by the preemption flag in epoch 2 and resumed ends
  on a ``checkpoint_last`` bit-equal to a straight run's.
* ``speech_recognize`` (greedy) on a port checkpoint of a tiny JAX model's
  variables writes JAX's four result files byte for byte, and returns
  JAX's dict.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from espresso_tpu import config as jax_config
from espresso_tpu.train import checkpoint as jax_ckpt
from espresso_tpu_torch import config as port_config
from espresso_tpu_torch.train import checkpoint as ckpt
from test_torch_recipe_cli import TINY
from utils import make_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (epoch, val_metric, end_of_epoch, updates) in order, as the train loop
# calls save_epoch: mid-epoch saves at updates, epoch ends with a metric
SEQUENCE = [(1, None, False, 2), (1, None, False, 4), (1, 3.5, True, 5), (2, None, False, 6),
            (2, 2.5, True, 10), (3, 2.75, True, 15), (4, 1.25, True, 20), (5, None, False, 22),
            (5, 1.5, True, 25), (6, 1.0, True, 30)]


@pytest.mark.parametrize("settings", [
    {},
    {"keep_last_epochs": 2, "save_interval_updates": 2},
    {"keep_best_checkpoints": 2, "save_interval": 2},
    {"keep_best_checkpoints": 3, "maximize_best_checkpoint_metric": True, "keep_last_epochs": 1},
    {"save_interval": 0, "save_interval_updates": 4, "keep_best_checkpoints": 1},
    {"no_save": True},
])
def test_checkpoint_policy_names_match_jax(tmp_path, monkeypatch, settings):
    monkeypatch.setattr(jax_ckpt, "save_checkpoint_state",
                        lambda path, state, host_state, async_write=False: os.makedirs(path, exist_ok=True))
    state = {"params/w": np.zeros(3, np.float32), "step": np.asarray(0, np.int64)}
    managers = []
    for name, cfg_mod, mod in (("jax", jax_config, jax_ckpt), ("port", port_config, ckpt)):
        cfg = cfg_mod.EspressoConfig()
        cfg.checkpoint.save_dir = str(tmp_path / name)
        for k, v in settings.items():
            setattr(cfg.checkpoint, k, v)
        managers.append(mod.CheckpointManager(cfg))
    for epoch, metric, end, updates in SEQUENCE:
        got = [m.save_epoch(state, {"iterator": {"epoch": epoch}}, epoch, val_metric=metric,
                            end_of_epoch=end, updates=updates) for m in managers]
        assert got[0] == got[1]
        assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
        assert managers[0].best == managers[1].best
    if not settings.get("no_save"):
        hs = json.load(open(tmp_path / "port" / "checkpoint_last" / ckpt.HOST_STATE_FILE))
        assert hs == {"iterator": {"epoch": 6}, "best": managers[0].best}


def test_average_checkpoints_matches_jax_bit_for_bit(tmp_path):
    """Three checkpoints of one params tree, orbax for JAX and the port's
    format for the port: the averaged params are equal bit for bit, with
    --inputs and with --num-epoch-checkpoints."""
    import orbax.checkpoint as ocp

    from espresso_tpu.cli import average_checkpoints as jax_avg
    from espresso_tpu_torch.cli import average_checkpoints as port_avg

    rng = np.random.default_rng(0)
    shapes = {"enc": {"Dense_0": {"kernel": (5, 7), "bias": (7,)}}, "joint": {"scale": (3,)}}
    trees = [jax.tree_util.tree_map(lambda s: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 3)).astype(np.float32),
                                    shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    for i, tree in enumerate(trees, 1):
        state = {"params": tree, "step": np.asarray(i, np.int32)}
        with ocp.StandardCheckpointer() as c:
            c.save(str(tmp_path / "jax" / f"checkpoint{i}" / "state"), state)
        with open(tmp_path / "jax" / f"checkpoint{i}" / "host_state.json", "w") as f:
            json.dump({"best": float(i)}, f)
        ckpt.save_checkpoint_state(str(tmp_path / "port" / f"checkpoint{i}"),
                                   ckpt.flatten_tree(state), {"best": float(i)})
    for tag, argv in (("all", lambda r: ["--inputs"] + [str(tmp_path / r / f"checkpoint{i}") for i in (1, 2, 3)]),
                      ("last2", lambda r: ["--inputs", str(tmp_path / r), "--num-epoch-checkpoints", "2"])):
        jax_avg.main(argv("jax") + ["--output", str(tmp_path / f"jax_{tag}")])
        port_avg.main(argv("port") + ["--output", str(tmp_path / f"port_{tag}")])
        with ocp.StandardCheckpointer() as c:
            want = c.restore(str(tmp_path / f"jax_{tag}" / "state"))
        got, host = ckpt.load_checkpoint_state(str(tmp_path / f"port_{tag}"))
        flat_w, flat_g = ckpt.flatten_tree(want["params"]), ckpt.flatten_tree(got["params"])
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            w, g = np.asarray(flat_w[k]), flat_g[k]
            assert g.dtype == w.dtype == np.float32 and g.tobytes() == w.tobytes(), k
        assert int(got["step"]) == int(want["step"])
        assert host == json.load(open(tmp_path / f"jax_{tag}" / "host_state.json")) == {"best": 3.0}


def _train_corpus(d):
    make_corpus(d, "train", num_utts=16, feat_dim=12, seed=0, max_words=3)
    make_corpus(d, "valid", num_utts=4, feat_dim=12, seed=1, max_words=3)


def test_preempted_and_resumed_run_is_bit_equal_to_a_straight_run(tmp_path, monkeypatch):
    """The train CLI for 2 epochs with dropout, SpecAugment, quant noise and
    an EMA (the step generator, the quant-noise compute buffer and every
    array of the state matter): a run stopped by the preemption flag after
    2 updates of epoch 2 and resumed from its checkpoint_last ends on the
    same checkpoint_last as a run without the stop, array for array and in
    host_state.json."""
    from espresso_tpu_torch.cli import train

    d = str(tmp_path)
    _train_corpus(d)
    extra = ["model.encoder.dropout=0.1", "model.pred_dropout=0.1", "optimization.ema_decay=0.9",
             "optimization.quant_noise_pq=0.1", "optimization.quant_noise_block_size=4",
             "dataset.max_tokens=400", "optimization.max_epoch=2",
             "dataset.specaugment_config={'W': 0, 'F': 3, 'T': 5, 'num_freq_masks': 1, 'num_time_masks': 1}"]
    base = [f"dataset.data={d}"] + TINY + extra
    train.main(base + [f"checkpoint.save_dir={d}/straight"], device="cpu")

    make_step = train.make_train_step
    steps = []

    def stopping(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen):
            out = step(state, batch, gen)
            steps.append(state.step)
            if len(steps) == n_epoch1 + 2:
                train._PREEMPT.set()
            return out
        return run

    n_epoch1 = int(ckpt.load_raw_checkpoint(f"{d}/straight/checkpoint1")["step"])
    n_total = int(ckpt.load_raw_checkpoint(f"{d}/straight/checkpoint_last")["step"])
    assert n_total - n_epoch1 >= 4, (n_epoch1, n_total)
    monkeypatch.setattr(train, "make_train_step", stopping)
    train.main(base + [f"checkpoint.save_dir={d}/resumed"], device="cpu")
    stopped, host = ckpt.load_checkpoint_state(f"{d}/resumed/checkpoint_last")
    assert int(stopped["step"]) == n_epoch1 + 2
    assert host["iterator"] == {"epoch": 2, "iterations_in_epoch": 2, "shuffle": True}
    assert "checkpoint2" not in os.listdir(f"{d}/resumed")
    monkeypatch.setattr(train, "make_train_step", make_step)
    train.main(base + [f"checkpoint.save_dir={d}/resumed"], device="cpu")
    want, want_host = ckpt.load_checkpoint_state(f"{d}/straight/checkpoint_last")
    got, got_host = ckpt.load_checkpoint_state(f"{d}/resumed/checkpoint_last")
    fw, fg = ckpt.flatten_tree(want), ckpt.flatten_tree(got)
    assert fw.keys() == fg.keys()
    assert {"rng", "opt_state/mu", "opt_state/nu", "opt_state/count", "overflow_count", "step"} <= fw.keys()
    assert any(k.startswith("ema_params/") for k in fw) and any(k.startswith("batch_stats/") for k in fw)
    for k in fw:
        assert fw[k].dtype == fg[k].dtype and fw[k].tobytes() == fg[k].tobytes(), k
    assert got_host == want_host and int(got["step"]) == n_total


def _jax_variables(jmodel, frames, lengths, seed):
    """The JAX model's variables drawn in numpy on the shapes of its init
    (jax.eval_shape: no init compile): scaled normal weights, the joint's
    output layer peaked x6 so that no greedy argmax is a near-tie between
    the two frameworks, batch-norm variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), frames, lengths,
                            np.zeros((frames.shape[0], 2), np.int32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else 8
        a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) >= 2 else fan_in)
        if names[-1] == "scale":
            a = 1.0 + 0.1 * a
        if "fc_out" in names:
            a = a * 6.0
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(shapes))


def test_speech_recognize_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    """JAX's speech_recognize, greedy, on an orbax checkpoint_last of a
    tiny JAX model's variables, and the port's on its own checkpoint of the
    same variables (keyed and laid out as the flax tree), both from one
    model_cfg.json: decoded_results.txt, wer, cer and aligned_results.txt
    equal byte for byte, and the returned dicts equal."""
    import orbax.checkpoint as ocp

    from espresso_tpu.cli import speech_recognize as jax_rec
    from espresso_tpu.tasks import setup_task as jax_setup_task
    from espresso_tpu_torch.cli import speech_recognize as port_rec
    from espresso_tpu_torch.cli.train import write_model_cfg
    from espresso_tpu_torch.tasks import setup_task as port_setup_task

    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")
    d = str(tmp_path)
    make_corpus(d, "test", num_utts=6, feat_dim=12, seed=3, max_words=4)
    train_argv = [f"dataset.data={d}", "dataset.train_subset=test"] + TINY
    pcfg = port_config.parse_config(train_argv)
    ptask = port_setup_task(pcfg)
    pmodel = ptask.build_model(device="cpu")
    jtask = jax_setup_task(jax_config.parse_config(train_argv))
    jtask.load_dataset("test")
    jmodel = jtask.build_model()
    variables = _jax_variables(jmodel, np.zeros((2, 40, 12), np.float32), np.array([40, 30], np.int32), 5)
    for name in ("jax", "port"):
        write_model_cfg(f"{d}/{name}", pmodel, pcfg, ptask.model_cfg)
    with ocp.StandardCheckpointer() as c:
        c.save(f"{d}/jax/checkpoint_last/state", {"params": variables["params"],
                                                  "batch_stats": variables["batch_stats"]})
    ckpt.save_checkpoint_state(f"{d}/port/checkpoint_last", ckpt.flatten_tree(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}), {})
    argv = lambda name: [f"dataset.data={d}", "dataset.feat_dim=12", "dataset.max_tokens=100000",
                         "dataset.num_batch_buckets=1", "common.dtype=float32",
                         f"checkpoint.save_dir={d}/{name}", f"generation.results_path={d}/{name}_out"]
    # JAX's decode CLI builds a whole train state (model.init, op by op:
    # ~30 s on one core) only for the params tree's structure, which it
    # checks against the checkpoint's and then replaces; a state of that
    # structure from the eval_shape draw stands in for it
    from espresso_tpu.train.trainer import TrainState

    monkeypatch.setattr(jax_rec, "create_train_state", lambda *a, **kw: TrainState(
        step=0, params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None))
    want = jax_rec.main(argv("jax"))
    got = port_rec.main(argv("port"), device="cpu")
    assert got == want and want["num_utts"] == 6
    files = ("decoded_results.txt", "wer", "cer", "aligned_results.txt")
    assert sorted(os.listdir(f"{d}/port_out")) == sorted(files)
    for f in files:
        assert open(f"{d}/port_out/{f}", "rb").read() == open(f"{d}/jax_out/{f}", "rb").read(), f
    hyps = [line.split(" ", 1)[1].strip() for line in open(f"{d}/port_out/decoded_results.txt")]
    assert sum(len(h.split()) for h in hyps) >= 6, hyps  # the peaked model emits
