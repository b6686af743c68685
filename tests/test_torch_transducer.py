"""Parity of the port's Conformer-Transducer greedy serving path against JAX.

A small copy of the flagship (2 conformer layers, D=128, H=2, ffn 256, conv
kernel 31, pred 2x128, joint 128, V=64) is initialised in JAX, its variables
perturbed from a numpy seed (so biases, batch statistics and the positional
biases are not trivial), and loaded into the port through ``bridge.py``.
Everything runs in fp32 on the CPU, where the attention wrapper runs its
plain version.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from espresso_tpu.data.dictionary import AsrDictionary as JaxDictionary
from espresso_tpu.decode.transducer_greedy import (
    TransducerGreedyDecoder as JaxGreedyDecoder,
)
from espresso_tpu.models.speech_transformer import (
    SpeechTransformerConfig as JaxEncoderConfig,
)
from espresso_tpu.models.transducer import (
    TransducerConfig as JaxTransducerConfig,
    TransducerModel as JaxTransducerModel,
)
from espresso_tpu.modules.conformer import (
    ConformerEncoderLayer as JaxConformerLayer,
)
from espresso_tpu.modules.conv_frontend import ConvFrontend as JaxConvFrontend
from espresso_tpu.modules.positional import (
    RelativePositionalEmbedding as JaxRelPos,
)
from espresso_tpu_torch.bridge import load_jax_variables
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.decode.transducer_greedy import TransducerGreedyDecoder
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.modules.conformer import ConformerEncoderLayer
from espresso_tpu_torch.modules.conv_frontend import ConvFrontend
from espresso_tpu_torch.modules.positional import RelativePositionalEmbedding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, T, F = 3, 48, 80
LENS = np.array([48, 37, 20], np.int32)
D, FFN, H, K, PRED, JOINT, V = 128, 256, 2, 31, 128, 128, 64
TOL = 1e-4  # fp32 on the CPU, summed in another order by each framework


def _jax_config():
    enc = JaxEncoderConfig(
        feat_dim=F, vocab_size=V, encoder_layer_type="conformer",
        encoder_pos_type="relative", encoder_embed_dim=D, encoder_ffn_dim=FFN,
        encoder_layers=2, encoder_heads=H, depthwise_conv_kernel_size=K, dropout=0.0,
    )
    return JaxTransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED,
        pred_hidden_size=PRED, pred_layers=2, pred_dropout=0.0, joint_dim=JOINT,
    )


def _port_config():
    enc = SpeechTransformerConfig(
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2,
        encoder_heads=H, depthwise_conv_kernel_size=K,
    )
    return TransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED,
        pred_hidden_size=PRED, pred_layers=2, joint_dim=JOINT,
    )


def _perturb(tree, rng):
    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel" or name == "embedding":
            return a
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, T, F)).astype(np.float32)
    jmodel = JaxTransducerModel(_jax_config())
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(frames), jnp.asarray(LENS),
        jnp.zeros((B, 2), jnp.int32),
    )
    variables = _perturb(jax.device_get(variables), rng)
    model = load_jax_variables(TransducerModel(_port_config()).eval(), variables)
    return jmodel, variables, model, frames


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for p in path:
            node = node[p]
        out[col] = node
    return out


def test_relative_positions_match():
    j = np.asarray(JaxRelPos(D, max_size=1024).apply({}, 12))
    t = RelativePositionalEmbedding(D, max_size=1024)(12).numpy()
    assert t.shape == (23, D)
    np.testing.assert_array_equal(t, j)


def test_conv_frontend_matches(setup):
    _, variables, _, frames = setup
    sub = _sub(variables, "encoder", "conv")
    j_out, j_len = JaxConvFrontend().apply(sub, jnp.asarray(frames), jnp.asarray(LENS))
    port = nn.ModuleDict({"conv": ConvFrontend()}).eval()
    load_jax_variables(port, {c: {"conv": sub[c]} for c in sub})
    with torch.no_grad():
        out, lens = port["conv"](torch.from_numpy(frames), torch.from_numpy(LENS))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)


def test_conformer_layer_matches(setup, monkeypatch):
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    _, variables, _, _ = setup
    rng = np.random.default_rng(2)
    Tl = 12
    x = rng.standard_normal((B, Tl, D)).astype(np.float32)
    mask = np.arange(Tl)[None, :] < np.array([12, 9, 5])[:, None]
    rel = np.array(JaxRelPos(D, max_size=1024).apply({}, Tl))  # writable copy
    sub = _sub(variables, "encoder", "layer0")
    j_out = JaxConformerLayer(D, FFN, H, depthwise_kernel_size=K).apply(
        sub, jnp.asarray(x), jnp.asarray(mask), None, jnp.asarray(rel)
    )
    layer = load_jax_variables(ConformerEncoderLayer(D, FFN, H, K).eval(), sub)
    with torch.no_grad():
        out = layer(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(rel))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL, atol=TOL)


def test_encoder_matches(setup, monkeypatch):
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jmodel, variables, model, frames = setup
    j = jmodel.apply(variables, jnp.asarray(frames), jnp.asarray(LENS), method="encode")
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames), torch.from_numpy(LENS))
    np.testing.assert_array_equal(enc.src_lengths.numpy(), np.asarray(j.src_lengths))
    np.testing.assert_array_equal(
        enc.encoder_padding_mask.numpy(), np.asarray(j.encoder_padding_mask)
    )
    np.testing.assert_allclose(
        enc.encoder_out.numpy(), np.asarray(j.encoder_out), rtol=TOL, atol=TOL
    )


def test_pred_step_and_joint_match(setup):
    jmodel, variables, model, _ = setup
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, V, size=B).astype(np.int32)
    h0 = rng.standard_normal((2, B, PRED)).astype(np.float32)
    c0 = rng.standard_normal((2, B, PRED)).astype(np.float32)
    enc = rng.standard_normal((B, D)).astype(np.float32)
    j_carry = (jnp.asarray(h0), jnp.asarray(c0), jnp.zeros((B, 0)), jnp.zeros((B,), jnp.int32))
    j_feat, (j_h, j_c, _, _) = jmodel.apply(
        variables, jnp.asarray(tokens), j_carry, method="pred_step"
    )
    j_proj = jmodel.apply(variables, jnp.asarray(enc), method="joint_enc_proj")
    j_logits = jmodel.apply(variables, j_proj, j_feat, method="joint_step_precomputed")
    j_pair = jmodel.apply(variables, jnp.asarray(enc), j_feat, method="joint_step")
    with torch.no_grad():
        feat, (h, c) = model.pred_step(
            torch.from_numpy(tokens).long(), (torch.from_numpy(h0), torch.from_numpy(c0))
        )
        proj = model.joint_enc_proj(torch.from_numpy(enc))
        logits = model.joint_step_precomputed(proj, feat)
        pair = model.joint_step(torch.from_numpy(enc), feat)
    for got, want in (
        (feat, j_feat), (h, j_h), (c, j_c), (proj, j_proj), (logits, j_logits),
        (pair, j_pair),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_greedy_decode_matches(setup, monkeypatch):
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jmodel, variables, model, frames = setup
    # peak the joint so near-ties cannot flip an argmax between frameworks
    peaked = jax.tree_util.tree_map(lambda a: a, variables)
    for leaf in ("kernel", "bias"):
        peaked["params"]["joint"]["fc_out"][leaf] = (
            variables["params"]["joint"]["fc_out"][leaf] * 6.0
        )
    load_jax_variables(model, peaked)
    batch = {"src_frames": frames, "src_lengths": LENS}
    want = JaxGreedyDecoder(jmodel, JaxDictionary(enable_bos=True), max_out_factor=0.35).decode(
        peaked, batch
    )
    got = TransducerGreedyDecoder(model, AsrDictionary(enable_bos=True), max_out_factor=0.35).decode(
        batch
    )
    load_jax_variables(model, variables)
    emitted = sum(len(h[0]["tokens"]) for h in got)
    assert emitted >= 5, emitted
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0]["tokens"], w[0]["tokens"])
        np.testing.assert_allclose(g[0]["score"], w[0]["score"], rtol=TOL, atol=TOL)


def test_bridge_rejects_missing_and_extra_leaves(setup):
    _, variables, _, _ = setup
    model = TransducerModel(_port_config())
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    del broken["params"]["joint"]["fc_out"]["bias"]
    with pytest.raises(ValueError, match="joint.fc_out.bias"):
        load_jax_variables(model, broken)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["joint"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="joint.stray.weight"):
        load_jax_variables(model, extra)


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax, flax nor the
    JAX package, and no source of the port imports them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import espresso_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'espresso_tpu_torch.')]\n"
        "for m in names: importlib.import_module(m)\n"
        "assert len(names) >= 15, names\n"
        "new = {'espresso_tpu_torch.train.trainer', 'espresso_tpu_torch.criterions',\n"
        "       'espresso_tpu_torch.config', 'espresso_tpu_torch.ops.rnnt_kernels',\n"
        "       'espresso_tpu_torch.features.fbank', 'espresso_tpu_torch.features.fbank_kernels',\n"
        "       'espresso_tpu_torch.features.cmvn', 'espresso_tpu_torch.features.transforms',\n"
        "       'espresso_tpu_torch.features.specaugment', 'espresso_tpu_torch.ops.quantization',\n"
        "       'espresso_tpu_torch.ops.front_kernel_checks', 'espresso_tpu_torch.models.lstm_lm',\n"
        "       'espresso_tpu_torch.models.speech_lstm', 'espresso_tpu_torch.registry',\n"
        "       'espresso_tpu_torch.tasks', 'espresso_tpu_torch.clib',\n"
        "       'espresso_tpu_torch.data.manifest', 'espresso_tpu_torch.data.kaldi_io',\n"
        "       'espresso_tpu_torch.data.audio', 'espresso_tpu_torch.data.encoders',\n"
        "       'espresso_tpu_torch.data.batching', 'espresso_tpu_torch.data.dataset',\n"
        "       'espresso_tpu_torch.data.iterators', 'espresso_tpu_torch.cli.train',\n"
        "       'espresso_tpu_torch.train.checkpoint', 'espresso_tpu_torch.train.metrics',\n"
        "       'espresso_tpu_torch.train.heartbeat', 'espresso_tpu_torch.tools.wer',\n"
        "       'espresso_tpu_torch.tools.scoring', 'espresso_tpu_torch.cli.speech_recognize',\n"
        "       'espresso_tpu_torch.cli.average_checkpoints', 'espresso_tpu_torch.cli.prep',\n"
        "       'espresso_tpu_torch.cli.logging_utils', 'espresso_tpu_torch.hub'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "bad = [m for m in ('jax', 'flax', 'espresso_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|espresso_tpu)\b", re.M)
    for dirpath, _, files in os.walk(os.path.join(root, "espresso_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name
