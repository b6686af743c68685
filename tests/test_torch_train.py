"""Parity of the port's train step against JAX ``make_train_step``.

A tiny flagship-shaped Conformer-Transducer (2 layers, D=128, H=2, ffn 256,
conv kernel 31, V=256, pred 2x128, joint 128) gets variables of the JAX
model's tree drawn from a numpy seed (biases, batch statistics and the
positional biases are not trivial), carried into the port by
``bridge.load_jax_variables``. Both run fp32 on the CPU at dropout 0: JAX
jits its train step, whose fused RNNT loss takes the XLA chunked path there;
the port's attention and joint wrappers run their plain versions. Each step
accumulates two microbatches, so one compiled JAX step serves every case.
The valid step is held to JAX ``make_valid_step`` on a waveform batch
through the device front (one more JAX compile, of the valid step).
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
    make_valid_step,
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
        encoder_layer_type="conformer", encoder_pos_type="relative",
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


def _jax_model():
    enc = JaxEncoderConfig(
        feat_dim=F, vocab_size=V, encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=H,
        depthwise_conv_kernel_size=K, dropout=0.0,
    )
    return JaxTransducerModel(JaxTransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED, pred_hidden_size=PRED,
        pred_layers=2, pred_dropout=0.0, joint_dim=JOINT,
    ))


@pytest.fixture(scope="module")
def jax_run():
    """JAX: the initial variables and the results of two steps, then of a
    step on a batch with a NaN frame."""
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    jmodel = _jax_model()
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


# each schedule name with fields of its own: warm-ups, decays, cycles and
# floors that the sampled steps below cross
SCHEDULES = {
    "fixed": dict(warmup_updates=100, warmup_init_lr=1e-7),
    "noam": dict(warmup_updates=12000, warmup_init_lr=1e-7, lr=5.0),
    "inverse_sqrt": dict(warmup_updates=100, warmup_init_lr=1e-7),
    "tri_stage": dict(phase_ratio=[0.1, 0.4, 0.5], total_num_update=20000, init_lr_scale=0.05,
                      final_lr_scale=0.02),
    "tri_stage_steps": dict(warmup_updates=100, hold_steps=900, decay_steps=11000),
    "cosine": dict(warmup_updates=100, warmup_init_lr=1e-7, total_num_update=15000, final_lr=1e-5),
    "polynomial": dict(warmup_updates=100, total_num_update=15000, power=2.0, final_lr=1e-5),
    "triangular": dict(max_lr=5e-3, lr_period_updates=7000, lr_shrink=0.5),
    "step": dict(warmup_updates=100, warmup_init_lr=1e-7, decay_steps=5000, lr_shrink=0.5),
    "pass_through": {},
    "reduce_lr_on_plateau_v2": {},
    "manual": dict(manual_lr=[1e-3, 5e-4]),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedules_match_jax(case):
    """Every name of JAX's ``build_lr_schedule``, each with its own fields;
    the epoch-driven names (plateau, manual) hold their base lr."""
    jcfg, pcfg = _configs()
    fields = dict(SCHEDULES[case])
    lr = fields.pop("lr", LR)
    for cfg in (jcfg, pcfg):
        cfg.lr_scheduler.name = "tri_stage" if case.startswith("tri_stage") else case
        for k, v in fields.items():
            setattr(cfg.lr_scheduler, k, v)
        cfg.optimization.lr = [lr]
    want = jax_lr_schedule(jcfg.lr_scheduler, jcfg.optimization)
    got = build_lr_schedule(pcfg.lr_scheduler, pcfg.optimization)
    for s in (0, 1, 50, 100, 999, 1000, 2000, 3500, 7000, 10000, 12000, 14000, 15000, 20000, 30000):
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


# the valid step on waveforms through the device front: JAX's fbank_fused
# and the port's plain fbank sum each frame's fp32 DFT products in other
# orders, and the 2-layer model and the RNNT loss carry that into the loss
# (9e-8 relative here); the train step's RTOL bounds it
VALID_RTOL = RTOL


def _wave_batch(rng):
    """One microbatch (no leading axis) of int16-scale waveforms for T
    frames, the second utterance 5 frames and 17 samples short."""
    S = (T - 1) * 160 + 400
    ns = np.array([S, S - 5 * 160 - 17], np.int32)
    wav = rng.standard_normal((B, S)) * 2000.0
    wav[np.arange(S)[None, :] >= ns[:, None]] = 0.0
    return {
        "src_waveforms": wav.astype(np.float32),
        "num_samples": ns,
        "prev_output_tokens": rng.integers(4, V, (B, U + 1)).astype(np.int32),
        "target": rng.integers(4, V, (B, U)).astype(np.int32),
        "tgt_lengths": np.array([U, 3], np.int32),
        "weight": np.array([1.0, 1.0], np.float32),
    }


def _valid_configs(cmvn_path, ema_validate):
    jcfg, pcfg = _configs()
    for cfg in (jcfg, pcfg):
        cfg.dataset.feature_type = "device_fbank"
        cfg.dataset.global_cmvn_stats_path = cmvn_path
        cfg.optimization.ema_validate = ema_validate
    return jcfg, pcfg


@pytest.fixture(scope="module")
def jax_valid(jax_run, tmp_path_factory):
    """JAX's valid step (one jit) on the state after two train steps, with
    its params and with its EMA params in their place (what
    ``ema_validate`` reads)."""
    _, _, out = jax_run
    rng = np.random.default_rng(3)
    wbatch = _wave_batch(rng)
    cmvn = str(tmp_path_factory.mktemp("cmvn") / "cmvn.npz")
    np.savez(cmvn, mean=rng.standard_normal(F).astype(np.float32) + 10.0,
             std=rng.uniform(1.0, 3.0, F).astype(np.float32))
    jcfg, _ = _valid_configs(cmvn, False)
    valid = jax.jit(jax_trainer.make_valid_step(_jax_model(), build_criterion(jcfg.criterion, _Task()), jcfg))
    jstate = out[1][0]
    jbatch = {k: jnp.asarray(v) for k, v in wbatch.items()}
    metrics = {
        False: jax.device_get(valid(jstate, jbatch)),
        True: jax.device_get(valid(jstate.replace(params=jstate.ema_params), jbatch)),
    }
    return wbatch, cmvn, metrics


@pytest.mark.parametrize("ema_validate", [False, True])
def test_valid_step_matches_jax_and_leaves_the_state(jax_run, jax_valid, ema_validate):
    """After two train steps: the valid loss, sample_size and logging equal
    JAX's within VALID_RTOL, in eval mode (running batch statistics, no
    dropout), with the EMA weights under ``ema_validate``; the train state,
    the batch statistics and the model's views of the compute buffer are
    as they were."""
    variables, batch, _ = jax_run
    wbatch, cmvn, jmetrics = jax_valid
    model, state, step = _port_setup(variables)
    tb = _torch_batch(batch)
    for _ in range(2):
        state, _ = step(state, tb)
    _, pcfg = _valid_configs(cmvn, ema_validate)
    valid = make_valid_step(model, TransducerCriterion(pcfg.criterion, _Dictionary()), pcfg)
    before = {
        "params": state.params.clone(), "ema": state.ema_params.clone(),
        "mu": state.opt_state.mu.clone(), "nu": state.opt_state.nu.clone(),
        **{k: v.clone() for k, v in model.state_dict().items()},
    }
    metrics = valid(state, _torch_batch(wbatch))
    assert not model.training
    want = jmetrics[ema_validate]
    assert set(metrics) == {"loss", "sample_size", "nsentences"} == set(want)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want[k]), rtol=VALID_RTOL, err_msg=k)
    if ema_validate:  # the EMA weights differ from the params: the loss does too
        assert abs(float(want["loss"]) - float(jmetrics[False]["loss"])) > 1e-3
    after = {
        "params": state.params, "ema": state.ema_params, "mu": state.opt_state.mu,
        "nu": state.opt_state.nu, **model.state_dict(),
    }
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert int(state.opt_state.count) == 2 and state.step == 2
    lo = state.compute.data_ptr()
    hi = lo + state.compute.numel() * state.compute.element_size()
    assert all(lo <= p.data_ptr() < hi for p in model.parameters())


def test_valid_step_on_bf16_compute_weights_normalises_in_f32(jax_run, jax_valid):
    """The train state of a bf16 run keeps its batch statistics in f32
    beside bf16 compute weights: in eval mode batch norm normalises such
    inputs in f32 from the running statistics and casts back, as flax
    promotes (torch's own batch norm refuses the mix). The bf16 valid loss
    is the fp32 one's within bf16 rounding through two layers (2 %)."""
    from espresso_tpu_torch.modules.batch_norm import BatchNorm

    bn = BatchNorm(6).eval()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-1, 1)
    x = torch.randn(3, 6, 5, generator=torch.Generator().manual_seed(0))
    want = bn(x)  # all f32: torch's own eval batch norm
    bn.weight.data, bn.bias.data = bn.weight.data.bfloat16(), bn.bias.data.bfloat16()
    got = bn(x.bfloat16())
    assert got.dtype == torch.bfloat16
    ref = ((x.bfloat16().float() - bn.running_mean[:, None]) * torch.rsqrt(bn.running_var[:, None] + 1e-5)
           * bn.weight.float()[:, None] + bn.bias.float()[:, None])
    assert torch.equal(got, ref.bfloat16())
    assert (got.float() - want).abs().max() < 0.05

    variables, _, _ = jax_run
    wbatch, cmvn, jmetrics = jax_valid
    losses = {}
    for dtype, ema in (("float32", False), ("bfloat16", False), ("bfloat16", True)):
        _, pcfg = _valid_configs(cmvn, ema)
        pcfg.common.dtype = dtype
        model = load_jax_variables(_port_model(), variables)
        optimizer, _ = build_optimizer(pcfg)
        state = create_train_state(model, optimizer, pcfg)
        valid = make_valid_step(model, TransducerCriterion(pcfg.criterion, _Dictionary()), pcfg)
        losses[dtype, ema] = valid(state, _torch_batch(wbatch))["loss"].item()
        lo = state.compute.data_ptr()
        hi = lo + state.compute.numel() * state.compute.element_size()
        assert all(lo <= p.data_ptr() < hi for p in model.parameters())  # restored after an EMA call
    assert np.isfinite(losses["bfloat16", False])
    np.testing.assert_allclose(losses["bfloat16", False], losses["float32", False], rtol=2e-2)
    # a fresh state's EMA is a copy of its params: its bf16 copy gives the same loss
    assert losses["bfloat16", True] == losses["bfloat16", False]
