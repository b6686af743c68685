"""The port's optimizers and epoch lr schedulers against the JAX package.

* Each ported optimizer (adam, adamw, adagrad, adadelta, adamax, sgd, nag,
  momentum), with and without weight decay, against the optax chain of
  JAX's ``build_optimizer`` on a small seeded parameter tree: three updates
  under a warm-up schedule (so the count the schedule reads matters), every
  parameter to ``P_ATOL``.
* Adafactor and composite against the same chains on a small torch model's
  parameters in their flax layout (``bridge``): kernels that factor (two
  dims of 128 or more, a convolution's among them) and kernels that do
  not, with and without weight decay; composite with two groups (one at
  ``lr_scale`` 0.1, one of adafactor) and the default; each parameter to
  ``FACTOR_RTOL``. Adafactor climbs the gradient in both (JAX's sign,
  ROADMAP queue C).
* ``ManualScheduler`` and ``PlateauScheduler`` give JAX's lr sequence on a
  fixed sequence of valid losses, through ``state_dict``/``load_state_dict``.
* In the port's train CLI (a tiny LSTM LM), a manual table's and a
  plateau's new lr reach the optimizer at the next epoch with its state
  carried on (JAX's ``tests/test_misc.py::test_manual_and_plateau_lr_reach_optimizer``).
* A run stopped by the preemption flag in epoch 3 and resumed, with
  momentum, with ``reduce_lr_on_plateau_v2`` (a shrink already made), with
  adafactor and with composite, ends on a checkpoint bit-equal to a
  straight run's.

fp32 on the CPU, torch on one thread.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.train import lr_schedulers as jax_sched
from espresso_tpu.train import trainer as jax_trainer
from espresso_tpu_torch import bridge
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.train import checkpoint as ckpt
from espresso_tpu_torch.train import lr_schedulers as port_sched
from espresso_tpu_torch.train import trainer

# an updated weight moves by ~lr a step: 2e-6 absolute is ~0.02 % of it
# (the transducer step's bound, tests/test_torch_train.py)
P_ATOL = 2e-6
SHAPES = {"a": (3, 7), "b": (11,), "c": (2, 2, 5)}
OPTIMIZERS = ["adam", "adamw", "adagrad", "adadelta", "adamax", "sgd", "nag", "momentum"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, weight_decay):
    out = []
    for cfg in (JaxConfig(), EspressoConfig()):
        cfg.optimizer.name = name
        cfg.optimizer.weight_decay = weight_decay
        cfg.optimizer.momentum = 0.9
        cfg.optimizer.adam_betas = (0.9, 0.98)
        cfg.optimization.lr = [0.05]
        cfg.lr_scheduler.warmup_updates = 2  # 0.01, 0.03, then 0.05
        cfg.lr_scheduler.warmup_init_lr = 0.01
        out.append(cfg)
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_match_optax(name, weight_decay):
    jcfg, pcfg = _configs(name, weight_decay)
    rng = np.random.default_rng(OPTIMIZERS.index(name))
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    tx, _ = jax_trainer.build_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt, _ = trainer.build_optimizer(pcfg)
    flat = lambda tree: torch.cat([torch.from_numpy(np.array(tree[k])).reshape(-1) for k in SHAPES])
    p = flat(params)
    state = opt.init(p)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(flat(g), state, p, torch.tensor(True))
        np.testing.assert_allclose(p.numpy(), flat(jp).numpy(), rtol=0, atol=P_ATOL)
    assert int(state.count) == 3
    # a skipped update leaves the weights and every slot as they were
    before = {k: v.clone() for k, v in state.tensors().items()}
    p0 = p.clone()
    opt.step(torch.full_like(p, float("nan")), state, p, torch.tensor(False))
    assert torch.equal(p, p0) and all(torch.equal(before[k], v) for k, v in state.tensors().items())


# adafactor's statistics per parameter: each updated weight to 1e-6
# relative (sums of 128-256 squares in another order), 1e-7 absolute (a
# weight near 0)
FACTOR_RTOL, FACTOR_ATOL = 1e-6, 1e-7


class _Net(nn.Module):
    """Parameters of the kinds adafactor tells apart. ``big``: a Dense
    kernel [160, 130] (flax layout) and a convolution's [1, 3, 140, 130]
    factor (the conv's two largest dims are its last two, its torch layout
    [130, 140, 1, 3]), an embedding [200, 144] too; else all are small. A
    [130, 7] kernel (one dim under 128), a 3x3 conv of 4 -> 8 channels, a
    layer norm's vectors and biases never factor."""

    def __init__(self, big: bool):
        super().__init__()
        n, m = (160, 130) if big else (20, 24)
        self.enc = nn.Linear(n, m)
        self.wide = nn.Conv2d(140 if big else 6, m, (1, 3))
        self.emb = nn.Embedding(200 if big else 30, 144 if big else 10)
        self.head = nn.Linear(m, 7)
        self.conv = nn.Conv2d(4, 8, 3)
        self.norm = nn.LayerNorm(m)


def _run_against_optax(model, jcfg, pcfg, steps=3, seed=0):
    """``steps`` updates of random gradients through JAX's chain on the
    flax-layout tree and the port's on the flat buffer; the weights after
    each step, JAX's in the port's layout."""
    leaves, (paths, _) = bridge.flax_leaves(model), bridge.flax_paths(model)
    rng = np.random.default_rng(seed)
    names = [n for n, _ in model.named_parameters()]
    shapes = {n: p.shape for n, p in model.named_parameters()}
    draw = lambda scale: {n: (rng.standard_normal(shapes[n]) * scale).astype(np.float32) for n in names}
    params = draw(1.0)

    def tree(arrays):
        out = {}
        for n in names:
            node = out
            for k in paths[n][:-1]:
                node = node.setdefault(k, {})
            node[paths[n][-1]] = jnp.asarray(bridge.to_flax_layout(leaves[n], arrays[n]))
        return out

    def flat(t):
        out = []
        for n in names:
            node = t
            for k in paths[n]:
                node = node[k]
            out.append(torch.from_numpy(np.array(bridge.from_flax_layout(leaves[n], np.asarray(node)))).reshape(-1))
        return torch.cat(out)

    tx, _ = jax_trainer.build_optimizer(jcfg)
    jp = tree(params)
    jstate = tx.init(jp)
    opt, _ = trainer.build_optimizer(pcfg)
    p = flat(jp)
    state = opt.init(p, trainer.param_blocks(model))
    out = []
    for _ in range(steps):
        g = draw(10.0 ** rng.uniform(-3, 0))
        updates, jstate = tx.update(tree(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(flat(tree(g)), state, p, torch.tensor(True))
        out.append((p.clone(), flat(jp)))
    return out, opt, state


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("big", [True, False], ids=["factored", "unfactored"])
def test_adafactor_matches_optax(big, weight_decay):
    """Three updates under the warm-up schedule: every weight against
    JAX's chain, the statistics factored exactly where optax factors them
    (in the flax layout); a skipped update leaves every slot as it was."""
    jcfg, pcfg = _configs("adafactor", weight_decay)
    model = _Net(big)
    steps, opt, state = _run_against_optax(model, jcfg, pcfg, seed=int(big))
    for got, want in steps:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FACTOR_RTOL, atol=FACTOR_ATOL)
    factored = [blk.top for blk, dims, _ in opt.plan if dims is not None]
    assert factored == (["enc", "wide", "emb"] if big else [])
    assert int(state.count) == 3
    before = {k: v.clone() for k, v in state.tensors().items()}
    p0 = steps[-1][0].clone()
    opt.step(torch.full_like(p0, float("nan")), state, p0, torch.tensor(False))
    assert all(torch.equal(before[k], v) for k, v in state.tensors().items())


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_composite_matches_optax(weight_decay):
    """JAX's ``_build_composite``: each top-level name to the group of its
    longest prefix, ``enc`` to ``e`` (adam at lr_scale 0.1), ``emb`` to
    ``emb`` (sgd; ``e`` is its prefix too), ``wide`` to adafactor, the rest
    to the default adam; three updates, every weight against JAX's
    ``optax.multi_transform``; the slots by group."""
    groups = {"e": {"name": "adam", "lr_scale": 0.1}, "emb": {"name": "sgd"}, "wide": {"name": "adafactor"}}
    jcfg, pcfg = _configs("composite", weight_decay)
    jcfg.optimizer.groups = pcfg.optimizer.groups = groups
    steps, opt, state = _run_against_optax(_Net(True), jcfg, pcfg, seed=2)
    for got, want in steps:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FACTOR_RTOL, atol=FACTOR_ATOL)
    assert {opt.label_of(t) for t in ("enc", "emb", "wide", "head", "conv", "norm")} == \
        {"e", "emb", "wide", "default"}
    assert opt.label_of("emb") == "emb" and opt.label_of("enc") == "e" and opt.label_of("head") == "default"
    assert {"e.mu", "e.nu", "wide.v_row", "wide.v_col", "wide.v", "default.mu", "count"} <= set(state.tensors())


def test_adafactor_climbs_the_gradient_as_jax_does():
    """JAX's adafactor chain ends in ``scale(-1)`` (optax) and
    ``build_optimizer`` appends ``scale_by_schedule(-lr)``: the update
    climbs the gradient. On sum(x^2) over a 256 x 256 matrix and a
    256-vector at lr 0.01, five updates raise the loss in JAX, and the
    port's losses are JAX's (1e-6 relative); adam lowers it."""
    rng = np.random.default_rng(0)
    x0 = {"w": rng.standard_normal((256, 256)).astype(np.float32),
          "b": rng.standard_normal(256).astype(np.float32)}
    losses = {}
    for name in ("adafactor", "adam"):
        jcfg, pcfg = _configs(name, 0.0)
        for cfg in (jcfg, pcfg):
            cfg.optimization.lr = [0.01]
            cfg.lr_scheduler.warmup_updates = 0
        tx, _ = jax_trainer.build_optimizer(jcfg)
        jp = {k: jnp.asarray(v) for k, v in x0.items()}
        jstate = tx.init(jp)
        model = nn.Module()
        model.w = nn.Parameter(torch.zeros(256, 256))
        model.b = nn.Parameter(torch.zeros(256))
        opt, _ = trainer.build_optimizer(pcfg)
        p = torch.cat([torch.from_numpy(x0["w"]).reshape(-1), torch.from_numpy(x0["b"])])
        state = opt.init(p, trainer.param_blocks(model))
        jl, pl = [], []
        for _ in range(5):
            updates, jstate = tx.update({k: 2 * v for k, v in jp.items()}, jstate, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step(2 * p, state, p, torch.tensor(True))
            jl.append(float(sum((v * v).sum() for v in jp.values())))
            pl.append(float((p.double() * p.double()).sum()))
        np.testing.assert_allclose(pl, jl, rtol=1e-6)
        losses[name] = jl
    start = float(sum((v.astype(np.float64) ** 2).sum() for v in x0.values()))
    assert losses["adafactor"][-1] > start > losses["adam"][-1]


@pytest.mark.parametrize("name", ["manual", "reduce_lr_on_plateau_v2"])
def test_epoch_schedulers_match_jax(name):
    """The lr after each epoch of a fixed valid-loss sequence, and a
    scheduler restored from the state_dict of epoch 3 goes on as the
    original does."""
    cfgs = []
    for cfg in (JaxConfig(), EspressoConfig()):
        cfg.lr_scheduler.name = name
        cfg.lr_scheduler.manual_lr = [1e-3, 5e-4, 2e-4, 1e-4]
        cfg.lr_scheduler.lr_shrink = 0.5
        cfg.lr_scheduler.start_reduce_lr_epoch = 2
        cfg.optimization.lr = [1e-3]
        cfgs.append(cfg)
    cls = "ManualScheduler" if name == "manual" else "PlateauScheduler"
    want = getattr(jax_sched, cls)(cfgs[0].lr_scheduler, cfgs[0].optimization)
    got = getattr(port_sched, cls)(cfgs[1].lr_scheduler, cfgs[1].optimization)
    assert type(port_sched.build_epoch_scheduler(cfgs[1].lr_scheduler, cfgs[1].optimization)) is type(got)
    losses = [4.0, 3.0, 3.5, 2.9, 2.89995, 2.95, None, 2.0]
    restored = None
    for epoch, loss in enumerate(losses, 1):
        lr = want.step_epoch(epoch, loss)
        assert got.step_epoch(epoch, loss) == lr, epoch
        if restored is not None:
            assert restored.step_epoch(epoch, loss) == lr, epoch
        if epoch == 3:
            restored = getattr(port_sched, cls)(cfgs[1].lr_scheduler, cfgs[1].optimization)
            restored.load_state_dict(got.state_dict())
    assert got.state_dict() == want.state_dict() == restored.state_dict()
    # the schedule the optimizer reads holds the lr the train loop sets
    sched = port_sched.build_lr_schedule(cfgs[1].lr_scheduler, cfgs[1].optimization)
    sched.set_lr(got.lr)
    assert sched(torch.tensor(7)).item() == np.float32(got.lr)


# a tiny LSTM LM on a seeded 30-unit text corpus
LM_ARGS = ["task.name=language_modeling_for_asr", "model.name=lstm_lm_wsj", "model.embed_dim=16",
           "model.hidden_size=24", "model.out_embed_dim=16", "model.num_layers=2",
           "criterion.name=cross_entropy_v2", "dataset.batch_size=8", "dataset.num_batch_buckets=2",
           "common.dtype=float32", "common.log_interval=100", "optimization.clip_norm=5.0"]


def write_lm_corpus(d, n_train=48, n_valid=8, units=30, seed=0):
    """dict.txt and {train,valid}.txt: sentences of 3 to 14 of ``units``
    units, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    vocab = [f"u{i:02d}" for i in range(units)]
    with open(os.path.join(d, "dict.txt"), "w") as f:
        f.writelines(f"{u} {units - i}\n" for i, u in enumerate(vocab))
    for split, n in (("train", n_train), ("valid", n_valid)):
        with open(os.path.join(d, f"{split}.txt"), "w") as f:
            for _ in range(n):
                f.write(" ".join(vocab[j] for j in rng.integers(0, units, rng.integers(3, 15))) + "\n")


def test_epoch_lr_reaches_the_optimizer(tmp_path, monkeypatch):
    """A manual table and a plateau shrink: each update reads the lr of its
    epoch, and the optimizer's count runs on across the change (its state
    is never reset)."""
    from espresso_tpu_torch.cli import train

    d = str(tmp_path)
    write_lm_corpus(d)
    seen = []
    orig = trainer.Optimizer.step

    def spy(self, grads, state, params, apply):
        seen.append((int(state.count), self.schedule(state.count).item()))
        return orig(self, grads, state, params, apply)

    monkeypatch.setattr(trainer.Optimizer, "step", spy)
    base = [f"dataset.data={d}", "optimization.max_epoch=3", "optimizer.name=momentum",
            "optimizer.momentum=0.9"] + LM_ARGS
    runs = {
        "manual": (["lr_scheduler.name=manual", "lr_scheduler.manual_lr=[0.01,0.005,0.0025]",
                    "optimization.lr=0.2"], [0.01, 0.005, 0.0025]),
        "plateau": (["lr_scheduler.name=reduce_lr_on_plateau_v2", "lr_scheduler.lr_shrink=0.5",
                     "lr_scheduler.lr_threshold=100.0", "optimization.lr=0.01"], [0.01, 0.01, 0.005]),
    }
    for tag, (extra, lrs) in runs.items():
        seen.clear()
        train.main(base + extra + [f"checkpoint.save_dir={d}/{tag}"], device="cpu")
        n = len(seen) // 3
        assert len(seen) == 3 * n and n > 0
        assert [c for c, _ in seen] == list(range(3 * n)), tag  # the count runs on
        want = [np.float32(lr) for lr in lrs for _ in range(n)]
        assert [lr for _, lr in seen] == want, tag
        host = ckpt.load_checkpoint_state(f"{d}/{tag}/checkpoint_last")[1]
        assert host["plateau"]["lr"] == 0.0025, tag  # the lr after epoch 3


@pytest.mark.parametrize("extra,slots", [
    (["optimizer.name=momentum", "optimizer.momentum=0.9", "optimization.lr=0.2"], {"trace"}),
    (["lr_scheduler.name=reduce_lr_on_plateau_v2", "lr_scheduler.lr_shrink=0.5",
      "lr_scheduler.lr_threshold=100.0", "optimization.lr=0.01", "model.dropout=0.2"], {"mu", "nu"}),
    (["optimizer.name=adafactor", "optimization.lr=0.01", "optimizer.weight_decay=0.01"],
     {"v_row", "v_col", "v"}),
    (["optimizer.name=composite", "optimization.lr=0.05",
      "optimizer.groups={'decoder': {'name': 'adafactor', 'lr_scale': 0.5}, 'default': {'name': 'sgd'}}"],
     {"decoder.v_row", "decoder.v_col", "decoder.v"}),
], ids=["momentum", "plateau", "adafactor", "composite"])
def test_preempted_lm_run_resumes_bit_equal(tmp_path, monkeypatch, extra, slots):
    """Three epochs straight, against a run stopped by the preemption flag
    after 2 updates of epoch 3 (the plateau has shrunk the lr after epoch 2)
    and resumed from its checkpoint_last: the same checkpoint_last, array
    for array and in host_state.json."""
    from espresso_tpu_torch.cli import train

    d = str(tmp_path)
    write_lm_corpus(d)
    base = [f"dataset.data={d}", "optimization.max_epoch=3"] + LM_ARGS + extra
    train.main(base + [f"checkpoint.save_dir={d}/straight"], device="cpu")
    n_epoch2 = int(ckpt.load_raw_checkpoint(f"{d}/straight/checkpoint2")["step"])
    make_step = train.make_train_step
    steps = []

    def stopping(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen):
            out = step(state, batch, gen)
            steps.append(state.step)
            if len(steps) == n_epoch2 + 2:
                train._PREEMPT.set()
            return out
        return run

    monkeypatch.setattr(train, "make_train_step", stopping)
    train.main(base + [f"checkpoint.save_dir={d}/resumed"], device="cpu")
    stopped, host = ckpt.load_checkpoint_state(f"{d}/resumed/checkpoint_last")
    assert int(stopped["step"]) == n_epoch2 + 2 and host["iterator"]["epoch"] == 3
    monkeypatch.setattr(train, "make_train_step", make_step)
    train.main(base + [f"checkpoint.save_dir={d}/resumed"], device="cpu")
    want, want_host = ckpt.load_checkpoint_state(f"{d}/straight/checkpoint_last")
    got, got_host = ckpt.load_checkpoint_state(f"{d}/resumed/checkpoint_last")
    fw, fg = ckpt.flatten_tree(want), ckpt.flatten_tree(got)
    slots = {f"opt_state/{k}" for k in slots}
    assert fw.keys() == fg.keys() and slots | {"opt_state/count", "rng", "step"} <= fw.keys()
    for k in fw:
        assert fw[k].dtype == fg[k].dtype and fw[k].tobytes() == fg[k].tobytes(), k
    assert got_host == want_host
    if "plateau" in want_host:
        assert want_host["plateau"]["lr"] == 0.0025  # shrunk after epochs 2 and 3
