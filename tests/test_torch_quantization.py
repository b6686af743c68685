"""Parity of the port's quantization module against the JAX package.

``int8_matmul`` (its plain version runs on a CPU tensor) against JAX
``int8_matmul(interpret=True)``, bit for bit; ``quantize_params_int8``, the
iPQ walkers and the quant-noise leaf set and block layout against JAX
through the bridge, on a tiny Conformer-Transducer; and the train step's
quant noise: the gradient reaching the masters is ``mask / (1 - p)`` times
that of a step on pre-noised weights, and the masters are never noised.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.models.speech_transformer import (
    SpeechTransformerConfig as JaxEncoderConfig,
)
from espresso_tpu.models.transducer import (
    TransducerConfig as JaxTransducerConfig,
    TransducerModel as JaxTransducerModel,
)
from espresso_tpu.ops import quantization as jq
from espresso_tpu_torch.bridge import flax_leaves, jax_state_dict, load_jax_variables, port_key
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import TransducerCriterion
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import quantization as pq
from espresso_tpu_torch.train.trainer import (
    build_optimizer,
    create_train_state,
    make_train_step,
)

B, T, F, U = 2, 32, 80, 4
D, FFN, H, K, PRED, V = 64, 128, 2, 7, 64, 40
# a small model's leaves: noise and quantize those of >= 1024 elements
MIN_SIZE = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model():
    enc = SpeechTransformerConfig(
        encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=H,
        depthwise_conv_kernel_size=K, dropout=0.0,
    )
    return TransducerModel(TransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED, pred_hidden_size=PRED,
        pred_layers=2, pred_dropout=0.0, joint_dim=PRED,
    ))


@pytest.fixture(scope="module")
def variables():
    """A flax variable tree of the tiny model (shapes from ``eval_shape``,
    which compiles nothing), drawn from a numpy seed."""
    enc = JaxEncoderConfig(
        feat_dim=F, vocab_size=V, encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=H,
        depthwise_conv_kernel_size=K, dropout=0.0,
    )
    jmodel = JaxTransducerModel(JaxTransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED, pred_hidden_size=PRED,
        pred_layers=2, pred_dropout=0.0, joint_dim=PRED,
    ))
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((B, T, F)), jnp.full((B,), T, jnp.int32),
        jnp.zeros((B, U + 1), jnp.int32),
    )
    rng = np.random.default_rng(0)

    def leaf(s):
        x = rng.standard_normal(s.shape) * 0.1
        return x.astype(np.float32) + (1.0 if len(s.shape) == 1 else 0.0)

    return jax.tree_util.tree_map(leaf, shapes)


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and not v.get("__int8__") and not v.get("__pq__"):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "M,Kd,N,dtype",
    [(64, 256, 128, "float32"), (13, 200, 100, "float32"), (40, 96, 72, "bfloat16")],
)
def test_int8_matmul_matches_jax_bit_exact(M, Kd, N, dtype):
    """Aligned and ragged shapes, f32 and bf16 activations: the port's plain
    version against JAX's Pallas kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(M + Kd + N)
    x = rng.standard_normal((M, Kd)).astype(np.float32) * 3.0
    x[0, :] = 0.0  # an all-zero row takes the 1e-8 scale floor
    w = rng.standard_normal((Kd, N)).astype(np.float32)
    q, s = jq.quantize_int8(w, axis=-1)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jq.int8_matmul(jx, jnp.asarray(q), jnp.asarray(s), interpret=True))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = pq.int8_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    # the card's layout: w_q as the transposed view of an [N, K] tensor
    wt = torch.from_numpy(np.ascontiguousarray(q.T)).t()
    assert torch.equal(pq.int8_matmul(tx, wt, torch.from_numpy(s)), got)


# ---------------------------------------------------------------------------
# the parameter walkers, through the bridge
# ---------------------------------------------------------------------------


def test_quantize_params_int8_matches_jax(variables):
    model = load_jax_variables(_port_model(), variables)
    jtree, jn_q, jn_total = jq.quantize_params_int8(variables["params"], min_size=MIN_SIZE)
    ptree, n_q, n_total = pq.quantize_params_int8(model, min_size=MIN_SIZE)
    assert (n_q, n_total) == (jn_q, jn_total) and n_q >= 10
    by_key = {port_key(path): v for path, v in _flat_paths(jtree)}
    assert set(by_key) == set(ptree)
    for key, v in ptree.items():
        jv = by_key[key]
        if isinstance(v, dict):
            np.testing.assert_array_equal(v["q"], jv["q"].T, err_msg=key)
            np.testing.assert_array_equal(v["scale"], jv["scale"], err_msg=key)
        else:
            assert not isinstance(jv, dict), key
    back = pq.dequantize_params_int8(ptree)
    jback = jax_state_dict({"params": jq.dequantize_params_int8(jtree)})
    for key, t in back.items():
        np.testing.assert_array_equal(t.numpy(), jback[key], err_msg=key)


def test_pq_params_match_jax(variables):
    model = load_jax_variables(_port_model(), variables)
    # the leaves of >= 20000 elements: the frontend's 4-D convolution
    # kernels and its 2-D output projection
    ptree = pq.pq_quantize_params(model, n_centroids=16, min_size=20000)
    jtree = jq.pq_quantize_params(variables["params"], n_centroids=16, min_size=20000)
    n = 0
    for path, jv in _flat_paths(jtree):
        key = port_key(path)
        if isinstance(jv, dict):
            n += 1
            np.testing.assert_array_equal(ptree[key]["codes"], jv["codes"], err_msg=key)
            np.testing.assert_array_equal(ptree[key]["centroids"], jv["centroids"], err_msg=key)
    assert n >= 2
    back = pq.pq_dequantize_params(ptree)
    jback = jax_state_dict({"params": jq.pq_dequantize_params(jtree)})
    for key, t in back.items():
        np.testing.assert_array_equal(t.numpy(), jback[key], err_msg=key)


def test_quant_noise_leaf_set_and_block_layout_match_jax(variables):
    """JAX noises a tree; its zeroed blocks, read in each leaf's flax layout,
    are fed to the port as the draw: the port then noises the same leaves
    and the same elements, to the same values."""
    p = 0.5
    model = load_jax_variables(_port_model(), variables)
    params = variables["params"]
    noised = jq.apply_quant_noise(params, jax.random.PRNGKey(3), p, 8, min_size=MIN_SIZE)
    want = jax_state_dict({"params": noised})
    before = jax_state_dict({"params": params})
    changed = {k for k in want if not np.array_equal(want[k], before[k])}
    qn = pq.QuantNoise(model, p, 8, min_size=MIN_SIZE)
    assert {name for name, *_ in qn.leaves} == changed
    leaves = flax_leaves(model)
    # the Embed table and the Dense kernels; no convolution kernel
    assert any(leaves[n] == "embedding" for n in changed)
    assert all(leaves[n] in ("kernel", "embedding") for n in changed)
    assert not any("conv.convs" in n or "depthwise" in n for n in changed)
    flax_masks = {}
    for path, leaf in _flat_paths(jax.tree_util.tree_map(np.asarray, noised)):
        flax_masks[port_key(path)] = leaf.reshape(-1) != 0
    keep_blocks = torch.from_numpy(np.concatenate(
        [flax_masks[name][::8] for name, *_ in qn.leaves]
    ))
    flat = torch.cat([p_.detach().reshape(-1) for p_ in model.parameters()])
    got = qn.apply(flat, qn.mask(keep_blocks))
    for (name, w), g in zip(model.named_parameters(), got.split([w.numel() for w in model.parameters()])):
        np.testing.assert_array_equal(g.view_as(w).numpy(), want[name], err_msg=name)
    # about p of the noised blocks were dropped
    assert abs(1.0 - float(keep_blocks.float().mean()) - p) < 0.05


# ---------------------------------------------------------------------------
# quant noise in the train step
# ---------------------------------------------------------------------------


class _Dictionary:
    def pad(self):
        return 1

    def blank(self):
        return 0


class _Recorder:
    """An optimizer that keeps the gradients it is handed and updates
    nothing."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params, blocks=None):
        return self.opt.init(params, blocks)

    def step(self, grads, state, params, apply):
        self.grads = grads.clone()


def _setup(variables, qn_p):
    cfg = EspressoConfig()
    cfg.common.dtype = "float32"
    cfg.optimization.quant_noise_pq = qn_p
    model = load_jax_variables(_port_model(), variables)
    optimizer = _Recorder(build_optimizer(cfg)[0])
    state = create_train_state(model, optimizer, cfg)
    step = make_train_step(model, TransducerCriterion(cfg.criterion, _Dictionary()), optimizer, cfg)
    return model, state, step, optimizer


def _batch():
    rng = np.random.default_rng(5)
    batch = {
        "src_frames": rng.standard_normal((1, B, T, F)).astype(np.float32),
        "src_lengths": np.array([[T, 27]], np.int32),
        "prev_output_tokens": rng.integers(4, V, (1, B, U + 1)).astype(np.int32),
        "target": rng.integers(4, V, (1, B, U)).astype(np.int32),
        "tgt_lengths": np.array([[U, 3]], np.int32),
        "weight": np.ones((1, B), np.float32),
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_noised_step_gradient_is_mask_over_keep_times_prenoised(variables):
    p = 0.1
    batch = _batch()
    model, state, step, rec = _setup(variables, p)
    masters = state.params.clone()
    state, metrics = step(state, batch, torch.Generator().manual_seed(7))
    assert torch.isfinite(metrics["loss"])
    assert state.compute is not state.params  # f32 noise needs its own copy
    # the masters were never noised, and the compute copy is restored
    assert torch.equal(state.params, masters) and torch.equal(state.compute, masters)

    # the same draw, made again, applied to the weights of a noise-free step
    qn = pq.QuantNoise(model, p, 8)
    keep = qn.mask(qn.draw(torch.Generator().manual_seed(7)))
    assert abs(1.0 - float(qn.draw(torch.Generator().manual_seed(7)).float().mean()) - p) < 0.02
    model2, state2, step2, rec2 = _setup(variables, 0.0)
    with torch.no_grad():
        state2.params.copy_(qn.apply(state2.params, keep))
    state2, metrics2 = step2(state2, batch)
    np.testing.assert_allclose(metrics["loss"].item(), metrics2["loss"].item(), rtol=1e-6)
    # 1/sample_size is applied before the mask here and after it in the
    # noised step: a rounding apart
    torch.testing.assert_close(rec.grads, qn.apply(rec2.grads, keep), rtol=1e-6, atol=1e-9)
    dropped = qn.noised & ~keep
    assert bool((rec.grads[dropped] == 0).all()) and bool(dropped.any())


def test_quant_noise_step_never_noises_masters_of_a_noise_free_state(variables):
    """An f32 state made with quant noise off (its compute buffer is the
    masters), stepped with quant noise on: the noise reaches neither the
    masters nor, after the step, the compute weights, step after step."""
    p = 0.1
    batch = _batch()
    model, state, step0, _ = _setup(variables, 0.0)
    assert state.compute is state.params
    state, metrics0 = step0(state, batch)  # the recorder updates nothing
    cfg = EspressoConfig()
    cfg.common.dtype = "float32"
    cfg.optimization.quant_noise_pq = p
    rec = _Recorder(build_optimizer(cfg)[0])
    step = make_train_step(model, TransducerCriterion(cfg.criterion, _Dictionary()), rec, cfg)
    masters = state.params.clone()
    gen = torch.Generator().manual_seed(11)
    for _ in range(2):
        state, metrics = step(state, batch, gen)
        assert torch.isfinite(metrics["loss"])
        assert metrics["loss"].item() != metrics0["loss"].item()  # the weights were noised
        assert torch.equal(state.params, masters) and torch.equal(state.compute, masters)
    weights = torch.cat([q.detach().reshape(-1) for q in model.parameters()])
    assert torch.equal(weights, masters)
