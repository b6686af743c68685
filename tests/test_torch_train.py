"""Parity of the port's train step against JAX ``make_train_step``.

A tiny flagship-shaped Conformer-Transducer (2 layers, D=128, H=2, ffn 256,
conv kernel 31, V=256, pred 2x128, joint 128) gets variables of the JAX
model's tree drawn from a numpy seed (biases, batch statistics and the
positional biases are not trivial), carried into the port by
``bridge.load_jax_variables``. Both run fp32 on the CPU at dropout 0: JAX
jits its train step, whose fused RNNT loss takes the XLA chunked path there;
the port's attention and joint wrappers run their plain versions. Each step
accumulates two microbatches, so one compiled JAX step serves every case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.criterions import build_criterion
from espresso_tpu.models.speech_transformer import (
    SpeechTransformerConfig as JaxEncoderConfig,
)
from espresso_tpu.models.transducer import (
    TransducerConfig as JaxTransducerConfig,
    TransducerModel as JaxTransducerModel,
)
from espresso_tpu.train import trainer as jax_trainer
from espresso_tpu.train.lr_schedulers import build_lr_schedule as jax_lr_schedule
from espresso_tpu_torch.bridge import jax_state_dict, load_jax_variables
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import TransducerCriterion
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import attention_kernels
from espresso_tpu_torch.train.lr_schedulers import build_lr_schedule
from espresso_tpu_torch.train.trainer import (
    build_optimizer,
    create_train_state,
    make_train_step,
)

N_MICRO, B, T, F, U = 2, 2, 32, 80, 5
D, FFN, H, K, PRED, JOINT, V = 128, 256, 2, 31, 128, 128, 256
CLIP, LR, EMA = 0.5, 1e-3, 0.9
# fp32 on the CPU, summed in another order by each framework: the loss and
# the gradient norm to 1e-5 relative; an updated weight moves by ~lr per
# step, so 2e-6 absolute is ~0.2 % of one step's move; the batch statistics
# to 1e-5
RTOL, P_ATOL, STATS_ATOL = 1e-5, 2e-6, 1e-5
# adam's epsilon: at the default 1e-8, adam's first steps are ~lr * sign(g)
# for every element, so rounding noise in a gradient near 0 (biases right
# before a batch norm and the key bias have gradient 0 in exact arithmetic,
# ~1e-6 of noise in each framework) moves a weight by up to lr either way;
# at 1e-4, below the typical |g| of ~5e-4 here, the update is a smooth
# function of the gradient and the comparison sees the arithmetic
ADAM_EPS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dictionary:
    def pad(self):
        return 1

    def blank(self):
        return 0


class _Task:
    dictionary = _Dictionary()


def _random_variables(shapes, rng):
    """Variables of the JAX model's tree (from ``jax.eval_shape`` of its
    init, which compiles nothing) drawn from ``rng``: kernels and embeddings
    at the scale of a LeCun init, non-trivial biases, scales, batch
    statistics and positional biases."""

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "var":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name != "embedding":
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(rng):
    lens = np.array([[T, 23], [27, T]], np.int32)
    tgt_lens = np.array([[U, 3], [4, U]], np.int32)
    return {
        "src_frames": rng.standard_normal((N_MICRO, B, T, F)).astype(np.float32),
        "src_lengths": lens,
        "prev_output_tokens": rng.integers(4, V, (N_MICRO, B, U + 1)).astype(np.int32),
        "target": rng.integers(4, V, (N_MICRO, B, U)).astype(np.int32),
        "tgt_lengths": tgt_lens,
        "weight": np.ones((N_MICRO, B), np.float32),
    }


def _configs():
    jcfg = JaxConfig()
    pcfg = EspressoConfig()
    jcfg.criterion.name = "transducer_loss"
    for cfg in (jcfg, pcfg):
        cfg.common.dtype = "float32"
        cfg.optimization.clip_norm = CLIP
        cfg.optimization.lr = [LR]
        cfg.optimization.ema_decay = EMA
        cfg.optimization.ema_start_update = 1
        cfg.optimizer.adam_eps = ADAM_EPS
    return jcfg, pcfg


def _port_model(dropout=0.0):
    enc = SpeechTransformerConfig(
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=H,
        depthwise_conv_kernel_size=K, dropout=dropout,
    )
    return TransducerModel(TransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED,
        pred_hidden_size=PRED, pred_layers=2, pred_dropout=dropout, joint_dim=JOINT,
    ))


def _port_setup(variables, dropout=0.0):
    _, pcfg = _configs()
    model = load_jax_variables(_port_model(dropout), variables)
    optimizer, _ = build_optimizer(pcfg)
    state = create_train_state(model, optimizer, pcfg)
    criterion = TransducerCriterion(pcfg.criterion, _Dictionary())
    step = make_train_step(model, criterion, optimizer, pcfg)
    return model, state, step


@pytest.fixture(scope="module")
def jax_run():
    """JAX: the initial variables and the results of two steps, then of a
    step on a batch with a NaN frame."""
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    enc = JaxEncoderConfig(
        feat_dim=F, vocab_size=V, encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=H,
        depthwise_conv_kernel_size=K, dropout=0.0,
    )
    jmodel = JaxTransducerModel(JaxTransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED, pred_hidden_size=PRED,
        pred_layers=2, pred_dropout=0.0, joint_dim=JOINT,
    ))
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.asarray(batch["src_frames"][0]),
        jnp.asarray(batch["src_lengths"][0]), jnp.asarray(batch["prev_output_tokens"][0]),
    )
    variables = _random_variables(shapes, rng)
    jcfg, _ = _configs()
    optimizer, _ = jax_trainer.build_optimizer(jcfg)
    criterion = build_criterion(jcfg.criterion, _Task())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=optimizer.init(params), ema_params=jax.tree_util.tree_map(jnp.copy, params),
        overflow_count=jnp.zeros((), jnp.int32),
    )
    step = jax.jit(jax_trainer.make_train_step(
        jmodel, criterion, optimizer, jcfg, ema_decay=jcfg.optimization.ema_decay
    ))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(2):
        state, metrics = step(state, jbatch, jax.random.PRNGKey(1))
        out.append((jax.device_get(state), jax.device_get(metrics)))
    bad = dict(jbatch, src_frames=jbatch["src_frames"].at[1, 0, 3, 5].set(jnp.nan))
    state, metrics = step(state, bad, jax.random.PRNGKey(1))
    out.append((jax.device_get(state), jax.device_get(metrics)))
    return variables, batch, out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _expected(jstate):
    return jax_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})


def _atol(key):
    return STATS_ATOL if key.endswith(("running_mean", "running_var")) else P_ATOL


def _check_state(model, jstate, steps):
    want = _expected(jstate)
    got = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key].detach().numpy(), w, rtol=RTOL, atol=_atol(key),
            err_msg=f"after {steps} steps: {key}",
        )


def _check_metrics(metrics, jmetrics):
    for k in ("loss", "sample_size", "gnorm", "overflow", "nsentences"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=RTOL, err_msg=k)


def test_one_and_two_train_steps_match_jax(jax_run):
    variables, batch, out = jax_run
    model, state, step = _port_setup(variables)
    tb = _torch_batch(batch)
    for i in range(2):
        state, metrics = step(state, tb)
        jstate, jmetrics = out[i]
        _check_metrics(metrics, jmetrics)
        assert metrics["gnorm"].item() > CLIP  # the clip acts
        # every weight after the update, and the batch-norm running stats
        _check_state(model, jstate, i + 1)
        assert int(state.opt_state.count) == int(jstate.opt_state[0].count) == i + 1
    # the EMA: a copy after the first update, decay 0.9 after the second
    ema = torch.split(state.ema_params, [p.numel() for p in model.parameters()])
    names = [n for n, _ in model.named_parameters()]
    want = jax_state_dict({"params": out[1][0].ema_params})
    for name, e in zip(names, ema):
        np.testing.assert_allclose(
            e.numpy(), want[name].reshape(-1), rtol=RTOL, atol=_atol(name), err_msg=name
        )


def test_non_finite_step_skips_update_and_counts(jax_run):
    variables, batch, out = jax_run
    model, state, step = _port_setup(variables)
    tb = _torch_batch(batch)
    for _ in range(2):
        state, _ = step(state, tb)
    before = state.params.clone()
    bad = dict(tb, src_frames=tb["src_frames"].clone())
    bad["src_frames"][1, 0, 3, 5] = float("nan")
    state, metrics = step(state, bad)
    jstate, jmetrics = out[2]
    assert metrics["overflow"].item() == float(jmetrics["overflow"]) == 1.0
    assert int(state.overflow_count) == int(jstate.overflow_count) == 1
    assert torch.equal(state.params, before)
    assert int(state.opt_state.count) == int(jstate.opt_state[0].count) == 2
    want = _expected(jstate)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want[name], rtol=RTOL, atol=_atol(name), err_msg=name
        )


@pytest.mark.parametrize("name", ["fixed", "noam"])
def test_lr_schedules_match_jax(name):
    jcfg, pcfg = _configs()
    for cfg in (jcfg, pcfg):
        cfg.lr_scheduler.name = name
        cfg.lr_scheduler.warmup_updates = 12000 if name == "noam" else 100
        cfg.lr_scheduler.warmup_init_lr = 1e-7
        cfg.optimization.lr = [5.0] if name == "noam" else [LR]
    want = jax_lr_schedule(jcfg.lr_scheduler, jcfg.optimization)
    got = build_lr_schedule(pcfg.lr_scheduler, pcfg.optimization)
    for s in (0, 1, 100, 12000, 20000):
        np.testing.assert_allclose(
            got(torch.tensor(s)).item(), float(want(jnp.int32(s))), rtol=1e-6, err_msg=str(s)
        )


def test_train_step_runs_with_dropout(jax_run):
    """At dropout 0.1 (the flagship's rate) the step runs and lowers the
    loss on its batch, and each attention layer's in-kernel mask keeps
    about 0.9 of the weights."""
    variables, batch, _ = jax_run
    model, state, step = _port_setup(variables, dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    seeds = []
    orig = attention_kernels.RelAttentionTrain.forward

    def spy(ctx, *args):
        seeds.append(int(args[6]))
        return orig(ctx, *args)

    tb = _torch_batch(batch)
    attention_kernels.RelAttentionTrain.forward = staticmethod(spy)
    try:
        losses = [step(state, tb, gen)[1]["loss"].item() for _ in range(3)]
    finally:
        attention_kernels.RelAttentionTrain.forward = staticmethod(orig)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert len(seeds) == 3 * N_MICRO * 2 and len(set(seeds)) == len(seeds)
    # the share kept by the masks these seeds draw, over every (item, head)
    # at T = 64 (~200k draws: one standard deviation is ~0.07 %)
    items, heads = torch.arange(B)[:, None], torch.arange(H)[None, :]
    kept = torch.stack([
        attention_kernels.dropout_keep_mask(s, items, heads, 64, 64, 0.1) for s in seeds
    ]).float().mean().item()
    assert abs(kept - 0.9) < 0.01, kept
