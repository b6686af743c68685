"""The port's transformer encoder-decoder (``speech_transformer``) against JAX.

A small ``SpeechTransformerModel`` (a 2-layer conv frontend on 12-dim
features, 2 transformer encoder layers and 2 decoder layers of 64, ffn 128,
4 heads, V = 40) is drawn in numpy on the shapes of JAX's init
(``jax.eval_shape``: no init compile) and carried into the port by
``bridge.load_jax_variables``. Held to JAX in fp32 on the CPU (the port's
kernel wrappers run their plain versions): the encoder layer with relative
and absolute positions in eval and train mode; the plain attention path
(causal, cross, a per-batch mask, with weights); the cached decode steps;
the teacher-forced logits of both position types and one label-smoothed CE
gradient in train mode; the greedy decoder; the beam search with and
without LSTM-LM fusion. Then the bf16 path at the librispeech width, the
bridge, the configs and presets against JAX's, the task's routing, a
train state's bit-equal resume, and what the port refuses. Each JAX
function compiles once a module. Torch runs on one thread.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_o0
from jax_o0 import jit_o0
from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.criterions import build_criterion as jax_build_criterion
from espresso_tpu.decode.beam_search import BeamSearchDecoder as JaxBeamSearch
from espresso_tpu.decode.greedy import SimpleGreedyDecoder as JaxGreedy
from espresso_tpu.models.lstm_lm import LSTMLanguageModel as JaxLM
from espresso_tpu.models.lstm_lm import LSTMLMConfig as JaxLMConfig
from espresso_tpu.models.speech_transformer import SpeechTransformerConfig as JaxSTConfig
from espresso_tpu.models.speech_transformer import SpeechTransformerModel as JaxModel
from espresso_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from espresso_tpu.modules.attention import MultiheadAttention as JaxMHA
from espresso_tpu.modules.conformer import TransformerEncoderLayer as JaxLayer
from espresso_tpu.modules.positional import sinusoidal_positions as jax_sinusoidal
from espresso_tpu.registry import apply_architecture as jax_apply_architecture
from espresso_tpu_torch.bridge import flax_paths, jax_state_dict, load_jax_variables, port_key
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import build_criterion
from espresso_tpu_torch.decode.api import TransformerDecoderAdapter, make_adapter
from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
from espresso_tpu_torch.decode.greedy import SimpleGreedyDecoder
from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig, SpeechTransformerModel
from espresso_tpu_torch.models.transducer import TransducerConfig
from espresso_tpu_torch.modules.attention import MultiheadAttention
from espresso_tpu_torch.modules.conformer import TransformerEncoderLayer
from espresso_tpu_torch.modules.dropout import set_dropout_generator
from espresso_tpu_torch.modules.positional import sinusoidal_positions
from espresso_tpu_torch.registry import apply_architecture
from espresso_tpu_torch.train import checkpoint as ckpt
from espresso_tpu_torch.train import trainer

F, B, T, U, V = 12, 3, 32, 5, 40
LENS = np.array([32, 21, 9], np.int32)  # 8, 6 and 3 encoder frames (4x subsampling)
D, FFN, H = 64, 128, 4
SMALL = dict(
    feat_dim=F, vocab_size=V, conv_channels=(4, 8), conv_kernel_sizes=((3, 3), (3, 3)),
    conv_strides=((2, 2), (2, 2)), encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=2,
    encoder_heads=H, decoder_embed_dim=D, decoder_ffn_dim=FFN, decoder_layers=2, decoder_heads=H,
    dropout=0.0, encoder_pos_type="relative",
)
EOS, PAD = 2, 1
# fp32 on the CPU, summed in other orders by each framework: activations and
# logits of O(1) to 1e-5 (the aim: 1e-4); decode scores (sums of a few
# log-probs) to 1e-5 relative; gradients to 1e-4 relative, each leaf against
# the largest gradient of the model (a conv bias before batch norm has a
# gradient of 0 in exact arithmetic, rounding noise in each framework)
ATOL, SCORE_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
# the cached step attends to the rows written so far, JAX's to all S rows
# with the rest masked: weights of exact zeros in f32, the same sums in
# another order (a logit of 30 is 2 f32 ulps off at 1e-6 relative)
STEP_RTOL = 1e-6
# the bf16 paths at the librispeech width: both round at other points (XLA
# fuses elementwise chains in f32, torch rounds after each op). The encoder
# output and the logits within BF16_ULPS bf16 ulps of their largest value
# (one draw: 0.031 at |x| <= 3.4 and 0.0625 at |x| <= 11.5, 2 and 1 ulps); a
# fault moves either by O(1). A greedy token is held to be JAX's argmax up
# to a near-tie: its JAX logit within that bound of the step's best
BF16_ULPS = 4
GREEDY_STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dictionary:
    count = [1] * 8

    def eos(self):
        return EOS

    def pad(self):
        return PAD


class _Task:
    dictionary = _Dictionary()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _draw(rng, peak=1.0):
    """Init-like values for a flax leaf: kernels at 1/sqrt(fan-in), the
    embedding (the tied output projection) at ``peak``/sqrt(d) and an
    untied ``fc_out`` at ``peak`` times its scale, batch variances in
    [0.5, 1.5], layer-norm scales near 1, the rest at 0.3."""

    def draw(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if names[-1] == "embedding":
            return (rng.standard_normal(s.shape) * peak / np.sqrt(s.shape[1])).astype(np.float32)
        scale = 1 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in names[-1] else 0.3
        a = rng.standard_normal(s.shape) * scale
        if names[-1] == "scale":
            a = 1.0 + 0.1 * a
        if "fc_out" in names:
            a = a * peak
        return np.asarray(a, np.float32)

    return draw


def _inputs(rng):
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    target = rng.integers(3, V, (B, U)).astype(np.int32)
    target[1, U - 2:], target[2, 2:] = PAD, PAD
    target[0, -1], target[1, U - 3], target[2, 1] = EOS, EOS, EOS
    prev = np.concatenate([np.full((B, 1), EOS, np.int32), target[:, :-1]], 1)
    return x, target, prev


def _models(seed, peak=1.0, **over):
    """(JAX model, its variables, the port model in eval mode, frames,
    target, prev_output_tokens) of SMALL with ``over``."""
    rng = np.random.default_rng(seed)
    kw = {**SMALL, **over}
    jmodel = JaxModel(JaxSTConfig(**kw))
    frames, target, prev = _inputs(rng)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), frames, LENS, prev)
    variables = jax.tree_util.tree_map_with_path(_draw(rng, peak), shapes)
    model = load_jax_variables(SpeechTransformerModel(SpeechTransformerConfig(**kw)).eval(), variables)
    return jmodel, variables, model, frames, target, prev


@pytest.fixture(scope="module")
def small():
    """The relative-position model (the recipe's; the tied embedding at
    x4, so that greedy and beam choices are not near-ties) that most cases
    share."""
    return _models(1, peak=4.0)


# -- modules ------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer_run():
    """JAX's TransformerEncoderLayer with relative and absolute positions,
    eval and train (dropout 0), from one compiled function; returns per
    position type (variables, x, mask, rel table, eval out, train out)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8, D)).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 6, 3])[:, None]
    rel = rng.standard_normal((15, D)).astype(np.float32)
    mods = {pos: JaxLayer(D, FFN, H, use_relative_pos=pos == "relative") for pos in ("relative", "abs")}
    variables = {
        pos: jax.tree_util.tree_map_with_path(
            _draw(rng), jax.eval_shape(m.init, jax.random.PRNGKey(0), x, mask, None, rel))
        for pos, m in mods.items()
    }

    def run(v):
        return {pos: tuple(m.apply(v[pos], x, mask, None, rel if pos == "relative" else None, train)
                           for train in (False, True)) for pos, m in mods.items()}

    out = jax.device_get(jax_o0.jit(run)(variables))
    return {pos: (variables[pos], x, mask, rel) + out[pos] for pos in mods}


@pytest.mark.parametrize("pos", ["relative", "abs"])
def test_encoder_layer_matches_jax(layer_run, pos):
    """The pre-norm transformer layer (flax ``Dense_0``/``Dense_1`` as fc1 /
    fc2) in eval mode (relative: B1's plain version) and in train mode at
    dropout 0 (relative: B2's), against JAX's."""
    variables, x, mask, rel, want_eval, want_train = layer_run[pos]
    layer = TransformerEncoderLayer(D, FFN, H, use_relative_pos=pos == "relative")
    holder = torch.nn.Module()  # the encoder's ``layer{i}`` parent names the auto-named Dense
    holder.layer0 = layer
    load_jax_variables(holder, {"params": {"layer0": variables["params"]}})
    table = _t(rel) if pos == "relative" else None
    with torch.no_grad():
        got_eval = layer.eval()(_t(x), _t(mask), table)
        got_train = layer.train()(_t(x), _t(mask), table)
    np.testing.assert_allclose(got_eval.numpy(), want_eval, atol=ATOL)
    np.testing.assert_allclose(got_train.numpy(), want_train, atol=ATOL)


ATTN_CASES = ("causal", "cross", "batch_mask")


@pytest.fixture(scope="module")
def attention_run():
    """JAX's plain MultiheadAttention (no relative positions): causal
    self-attention with a key padding mask, cross-attention on keys of
    another width and length, and self-attention with a [B, Tq, Tk] mask,
    each with its head-averaged weights, from one compiled function."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 6, D)).astype(np.float32)
    kv = rng.standard_normal((B, 9, 48)).astype(np.float32)
    kmask = np.arange(9)[None, :] < np.array([9, 4, 1])[:, None]
    qmask = np.arange(6)[None, :] < np.array([6, 5, 2])[:, None]
    causal = np.where(np.tril(np.ones((6, 6), bool)), 0.0, -1e8).astype(np.float32)
    bmask = np.where(rng.uniform(size=(B, 6, 6)) < 0.7, 0.0, -1e8).astype(np.float32)
    bmask[:, :, 0] = 0.0
    cases = {
        "causal": (q, q, dict(key_padding_mask=qmask, attn_mask=causal)),
        "cross": (q, kv, dict(key_padding_mask=kmask)),
        "batch_mask": (q, q, dict(attn_mask=bmask)),
    }
    mod = JaxMHA(D, H)
    shapes = {c: jax.eval_shape(mod.init, jax.random.PRNGKey(0), a, b, b, **kw) for c, (a, b, kw) in cases.items()}
    variables = {c: jax.tree_util.tree_map_with_path(_draw(rng), s) for c, s in shapes.items()}

    def run(v):
        return {c: mod.apply(v[c], a, b, b, need_weights=True, **kw)[:2] for c, (a, b, kw) in cases.items()}

    out = jax.device_get(jax_o0.jit(run)(variables))
    return {c: (variables[c],) + cases[c] + out[c] for c in cases}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_attention_matches_jax(attention_run, case):
    """The port's plain path (``use_relative_pos=False``), eval and train
    mode at dropout 0: the output and the head-averaged weights."""
    variables, q, kv, kw, want, want_w = attention_run[case]
    mha = load_jax_variables(
        MultiheadAttention(D, H, use_relative_pos=False, kdim=kv.shape[-1]), variables)
    assert not hasattr(mha, "pos_proj")  # JAX's leaves and nothing more
    qt, kvt = _t(q), (_t(q) if kv is q else _t(kv))
    kwt = {k: _t(v) for k, v in kw.items()}
    for mode in (mha.eval, mha.train):
        mode()
        with torch.no_grad():
            out, w = mha(qt, kvt, kvt, need_weights=True, **kwt)
        np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
        np.testing.assert_allclose(w.numpy(), want_w, atol=ATOL)


def test_plain_attention_dropout_keeps_the_rate_and_scales():
    """In train mode the plain path drops each weight with the layer's rate
    (from the layer's generator) and scales the kept ones by 1 / (1 -
    rate), flax's semantics (torch cannot replay flax's draws): one head,
    so the returned weights are the dropped ones; over 11,250 weights the
    dropped share within 0.02 of the rate (~4 standard deviations)."""
    torch.manual_seed(0)
    rate = 0.3
    mha = MultiheadAttention(16, 1, dropout=rate, use_relative_pos=False)
    set_dropout_generator(mha, torch.Generator().manual_seed(1))
    x = torch.randn(10, 15, 16)
    causal = torch.full((15, 15), -1e8).triu(1)
    with torch.no_grad():
        _, kept = mha.train()(x, x, x, attn_mask=causal, need_weights=True)
        _, full = mha.eval()(x, x, x, attn_mask=causal, need_weights=True)
    live = full > 0
    dropped = live & (kept == 0)
    assert abs(float(dropped.sum()) / float(live.sum()) - rate) < 0.02
    torch.testing.assert_close(kept[live & ~dropped], full[live & ~dropped] / (1 - rate))


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def small_run(small):
    """JAX's side of the shared model, compiled once: the teacher-forced
    logits and encoder output, and encode -> init_cache (max_len 8) -> U
    decode steps scanned over the step index (each step's logits and last
    layer's cross-attention weights)."""
    jmodel, variables, _, frames, _, prev = small

    def run(mdl, x, lens, toks):
        logits, enc = mdl(x, lens, toks)

        def step(cache, inp):
            tok, s = inp
            lg, cache, attn = mdl.decode_step(tok, s, cache, enc)
            return cache, (lg, attn)

        _, (step_logits, attns) = jax.lax.scan(step, mdl.init_cache(enc, 8), (toks.T, jnp.arange(toks.shape[1])))
        return logits, enc, jnp.moveaxis(step_logits, 0, 1), jnp.moveaxis(attns, 0, 1)

    return jax.device_get(jax_o0.jit(lambda v, x, p: jmodel.apply(v, x, LENS, p, method=run))(
        variables, frames, prev))


def test_cached_decode_steps_match_jax_and_decode_sequence(small, small_run):
    """``init_cache`` and ``decode_step`` over U steps: each step's logits
    and cross-attention weights against JAX's (which attends to all 8
    cache rows, the later ones masked; the port to the rows written so
    far: STEP_RTOL), and against the same row of the teacher-forced
    ``decode_sequence`` on the same tokens."""
    _, _, model, frames, _, prev = small
    _, _, want_logits, want_attn = small_run
    with torch.no_grad():
        enc = model.encode(_t(frames), _t(LENS))
        teacher = model.decode_sequence(_t(prev).long(), enc)
        cache = model.init_cache(enc, 8)
        for s in range(U):
            logits, cache, attn = model.decode_step(_t(prev[:, s]).long(), s, cache, enc)
            np.testing.assert_allclose(logits.numpy(), want_logits[:, s], rtol=STEP_RTOL, atol=ATOL,
                                       err_msg=f"step {s}")
            np.testing.assert_allclose(attn.numpy(), want_attn[:, s], rtol=STEP_RTOL, atol=ATOL)
            np.testing.assert_allclose(logits.numpy(), teacher[:, s].numpy(), rtol=STEP_RTOL, atol=ATOL)
    assert not cache[0]["self"]["k"][:, U:].any() and cache[0]["self"]["k"][:, :U].abs().min() > 0


@pytest.fixture(scope="module")
def abs_model():
    return _models(2, encoder_pos_type="abs")


@pytest.mark.parametrize("pos", ["relative", "abs"])
def test_teacher_forced_logits_match_jax(small, small_run, abs_model, pos):
    """The encoder output at every valid position and the teacher-forced
    logits, relative positions (the recipe's) and absolute ones (JAX's
    default: the table added after fc0, no embed scale)."""
    jmodel, variables, model, frames, _, prev = small if pos == "relative" else abs_model
    if pos == "relative":
        want, jenc = small_run[:2]
    else:
        want, jenc = jax_o0.jit(jmodel.apply)(variables, frames, LENS, prev)
    with torch.no_grad():
        got, enc = model(_t(frames), _t(LENS), _t(prev).long())
    np.testing.assert_array_equal(enc.src_lengths.numpy(), np.asarray(jenc.src_lengths))
    valid = np.asarray(jenc.encoder_padding_mask)[..., None]
    np.testing.assert_allclose(enc.encoder_out.numpy() * valid, np.asarray(jenc.encoder_out) * valid, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the fairseq table (an offset, an odd width) as JAX builds it
    np.testing.assert_array_equal(sinusoidal_positions(7, 9, 3).astype(np.float32),
                                  np.asarray(jax_sinusoidal(7, 9, 3)))


def test_label_smoothed_ce_gradient_matches_jax(small):
    """One label-smoothed CE (uniform, 0.1) in train mode at dropout 0 (the
    encoder's attention through B2/B3's plain versions, the frontend's
    batch norm on the batch's statistics): the loss, nll, token count and
    every parameter's gradient against JAX's criterion and VJP."""
    jmodel, variables, _, frames, target, prev = small
    jcfg, pcfg = JaxConfig(), EspressoConfig()
    for cfg in (jcfg, pcfg):
        cfg.criterion.name = "label_smoothed_cross_entropy_v2"
        cfg.criterion.label_smoothing = 0.1
    batch = {"src_frames": frames, "src_lengths": LENS, "target": target, "prev_output_tokens": prev,
             "weight": np.array([1, 1, 0], np.float32)}
    crit = jax_build_criterion(jcfg.criterion, _Task())

    def loss(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, frames, LENS,
                                 prev, train=True, mutable=["batch_stats"])
        model = type("M", (), {"apply": staticmethod(lambda v, *a, **kw: (logits[0], None))})
        res = crit(model, {"params": {}}, batch)
        return res[0], res[2]

    (jloss, jlog), jgrads = jax.device_get(jax_o0.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"]))
    model = load_jax_variables(SpeechTransformerModel(SpeechTransformerConfig(**SMALL)), variables).train()
    loss_t, size, logging = build_criterion(pcfg.criterion, _Task())(model, {k: _t(v) for k, v in batch.items()})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logging["nll_loss"].item(), float(jlog["nll_loss"]), rtol=1e-5)
    assert int(logging["ntokens"]) == int(jlog["ntokens"]) == 8 and int(size) == 8
    want = jax_state_dict({"params": jgrads})
    scale = max(np.abs(w).max() for w in want.values())
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale, err_msg=name)


def test_greedy_decoder_matches_jax():
    """JAX's SimpleGreedyDecoder and the port's (the caches stepped by the
    loop's index) at max_len 10: each utterance's tokens up to its first
    eos, and its score. An untied output layer (``fc_out`` x4): with a
    random tied one each step's input token scores highest, so greedy
    emits the leading eos at once."""
    jmodel, variables, model, frames, _, _ = _models(5, peak=4.0, share_decoder_input_output_embed=False)
    batch = {"src_frames": frames, "src_lengths": LENS}
    with jit_o0():
        want = JaxGreedy(jmodel, _Dictionary(), max_len_b=10).decode(variables, batch)
    got = SimpleGreedyDecoder(model, _Dictionary(), max_len_b=10).decode({k: _t(v) for k, v in batch.items()})
    assert sum(len(h[0]["tokens"]) for h in want) > 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0]["tokens"], w[0]["tokens"])
        np.testing.assert_allclose(g[0]["score"], w[0]["score"], rtol=SCORE_RTOL)


def _lm(seed):
    rng = np.random.default_rng(seed)
    kw = dict(vocab_size=V, embed_dim=8, hidden_size=12, out_embed_dim=10, num_layers=2, dropout=0.0)
    jlm = JaxLM(JaxLMConfig(**kw))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), jnp.zeros((2, 3), jnp.int32))
    variables = jax.tree_util.tree_map_with_path(_draw(rng, peak=3.0), shapes)
    return jlm, variables, load_jax_variables(LSTMLanguageModel(LSTMLMConfig(**kw)).eval(), variables)


@pytest.mark.parametrize("fused", [False, True], ids=["beam", "beam_lm"])
def test_beam_search_matches_jax(small, fused):
    """JAX's BeamSearchDecoder and the port's through
    ``TransformerDecoderAdapter`` (the caches reordered leaf by leaf): K =
    4, eos_factor 1.5, len_penalty 0.5, max_len 7; fused with an LSTM LM at
    lm_weight 0.4. Every one of the K hypotheses of each utterance is the
    same token sequence, its score within SCORE_RTOL."""
    jmodel, variables, model, frames, _, _ = small
    batch = {"src_frames": frames, "src_lengths": LENS}
    opts = dict(beam_size=4, max_len_b=7, eos_factor=1.5, len_penalty=0.5)
    jx, px = {}, {}
    if fused:
        jlm, lm_vars, lm = _lm(12)
        jx, px = dict(lm=jlm, lm_weight=0.4, lm_variables=lm_vars), dict(lm=lm, lm_weight=0.4)
    with jit_o0():
        want = JaxBeamSearch(jmodel, _Dictionary(), **opts, **jx).decode(variables, batch)
    dec = BeamSearchDecoder(model, _Dictionary(), **opts, **px)
    assert isinstance(dec.adapter, TransformerDecoderAdapter)
    got = dec.decode({k: _t(v) for k, v in batch.items()})
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == opts["beam_size"]
        for k, (gh, wh) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gh["tokens"], wh["tokens"], err_msg=f"utterance {b}, hyp {k}")
            np.testing.assert_allclose(gh["score"], wh["score"], rtol=SCORE_RTOL)
    assert len({tuple(h["tokens"]) for h in got[0]}) == opts["beam_size"]


def _flax_variables(model):
    """The port model's weights as a flax variable tree (``bridge.flax_paths``
    and the flax layouts), numpy f32."""
    from espresso_tpu_torch.bridge import to_flax_layout

    params, stats = flax_paths(model)
    tree = {}
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    for collection, paths in (("params", params), ("batch_stats", stats)):
        for name, path in paths.items():
            node = tree.setdefault(collection, {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.array(to_flax_layout(path[-1], named[name].detach().numpy()))
    return tree


def _bf16_bound(want: np.ndarray) -> float:
    """BF16_ULPS bf16 ulps at ``want``'s largest magnitude."""
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def test_bf16_paths_match_jax_at_librispeech_width():
    """The bf16 paths of both at speech_transformer_librispeech's widths (the
    4-layer frontend on 80-dim features, d 512, ffn 2048, 8 heads, relative
    positions, one encoder and one decoder layer, V = 5,003), B = 2, from
    the port's seeded init, variables and frames cast to bf16 as the decode
    CLIs cast them. The output layer is untied here (``fc_out`` at x4 its
    scale): a random tied one scores each step's input token highest, so
    greedy would end on the leading eos at once. The encoder output and the
    teacher-forced logits within BF16_ULPS; the port's greedy tokens (its
    caches in bf16, as JAX's take the encoder output's dtype) are the
    argmax chain of JAX's bf16 logits teacher-forced on them, up to
    near-ties."""
    cfg = SpeechTransformerConfig(feat_dim=80, vocab_size=5003, encoder_pos_type="relative",
                                  share_decoder_input_output_embed=False)
    apply_architecture("speech_transformer_librispeech", cfg)
    cfg.encoder_layers, cfg.decoder_layers, cfg.dropout = 1, 1, 0.0
    torch.manual_seed(13)
    model = SpeechTransformerModel(cfg).eval()
    with torch.no_grad():
        model.fc_out.weight.mul_(4.0)
    variables = _flax_variables(model)
    model.to(torch.bfloat16)
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((2, 48, 80)).astype(np.float32)
    lens = np.array([48, 29], np.int32)
    tframes = _t(frames).to(torch.bfloat16)
    with torch.no_grad():
        greedy = SimpleGreedyDecoder(model, _Dictionary(), max_len_b=GREEDY_STEPS).search(tframes, _t(lens))[0]
        prev = torch.cat([torch.full((2, 1), EOS), greedy[:, :-1].long()], 1)
        logits, enc = model(tframes, _t(lens), prev)
    jmodel = JaxModel(JaxSTConfig(**dataclasses.asdict(cfg)))
    jvars = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), variables)  # numpy casts, no compile
    want_logits, want_enc = (a.astype(np.float32) for a in jax.device_get(jax_o0.jit(
        lambda v, x, p: (lambda o: (o[0], o[1].encoder_out))(jmodel.apply(v, x, lens, p))
    )(jvars, jnp.asarray(frames).astype(jnp.bfloat16), prev.numpy().astype(np.int32))))
    assert enc.encoder_out.dtype == logits.dtype == torch.bfloat16
    valid = enc.encoder_padding_mask.numpy()[..., None]
    enc_err = np.abs(enc.encoder_out.float().numpy() - want_enc) * valid
    logit_err = np.abs(logits.float().numpy() - want_logits)
    bound = _bf16_bound(want_logits)
    assert enc_err.max() <= _bf16_bound(want_enc * valid) and logit_err.max() <= bound, \
        (enc_err.max(), logit_err.max(), bound)
    lengths = []
    for b in range(2):  # up to the row's first eos
        toks = greedy[b].numpy()
        end = next((i + 1 for i, t in enumerate(toks) if t == EOS), GREEDY_STEPS)
        lengths.append(end)
        picked = want_logits[b, np.arange(end), toks[:end]]
        assert (picked >= want_logits[b, :end].max(-1) - bound).all(), (b, toks, want_logits[b].argmax(-1))
    assert max(lengths) > 1


# -- bridge, configs, task, train state, refusals -------------------------------


def test_bridge_round_trip_and_tied_embedding(small):
    """Every JAX leaf of the model maps to a port tensor and back
    (``flax_paths`` is the inverse of ``port_key``), the encoder layers'
    auto-named ``Dense_0``/``Dense_1`` and the ``declayer{i}`` included;
    the tied output projection is the embedding itself: one parameter, one
    flax leaf ``embed_tokens/embedding``, and no ``fc_out``."""
    _, variables, model, _, _, _ = small
    paths, stats = flax_paths(model)
    for name, path in {**paths, **stats}.items():
        assert port_key(path) == name, (name, path)
    flat = {p: None for p, _ in jax.tree_util.tree_flatten_with_path(variables)[0]}
    want = {tuple(str(getattr(k, "key", k)) for k in p)[1:] for p in flat}
    assert set(paths.values()) | set(stats.values()) == want
    assert paths["encoder.layers.1.fc2.weight"] == ("encoder", "layer1", "Dense_1", "kernel")
    assert paths["decoder_layers.0.cross_attn.k_proj.bias"] == ("declayer0", "cross_attn", "k_proj", "bias")
    assert [n for n in paths if "embed" in n] == ["embed_tokens.weight"] and model.fc_out is None
    untied = SpeechTransformerModel(SpeechTransformerConfig(**{**SMALL, "share_decoder_input_output_embed": False}))
    assert flax_paths(untied)[0]["fc_out.weight"] == ("fc_out", "kernel")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["SpeechTransformerConfig", "TransducerConfig", "speech_transformer_wsj",
                                   "speech_transformer_librispeech", "speech_transformer_swbd",
                                   "conformer_transducer_librispeech"])
def test_config_defaults_and_presets_match_jax(which):
    """Every field default of both config dataclasses, and of each preset,
    equals JAX's (the transducer's encoder a conformer with relative
    positions, the attention model's a transformer with absolute ones)."""
    if which in ("SpeechTransformerConfig", "TransducerConfig"):
        got, want = {"SpeechTransformerConfig": (SpeechTransformerConfig(), JaxSTConfig()),
                     "TransducerConfig": (TransducerConfig(), JaxTransducerConfig())}[which]
    else:
        transducer = which.startswith("conformer")
        got, want = (TransducerConfig(), JaxTransducerConfig()) if transducer else \
            (SpeechTransformerConfig(), JaxSTConfig())
        apply_architecture(which, got)
        jax_apply_architecture(which, want)
    got_fields = _fields(got)
    if "encoder" in got_fields:
        assert _fields(got_fields.pop("encoder")) == _fields(_fields(want).pop("encoder"))
        assert got.encoder.encoder_layer_type == "conformer" and got.encoder.encoder_pos_type == "relative"
    assert got_fields == {k: v for k, v in _fields(want).items() if k != "encoder"}


@pytest.mark.parametrize("arch", ["speech_transformer_wsj", "speech_transformer_librispeech",
                                  "speech_transformer_swbd"])
def test_architectures_resolve_and_route_as_jax_does(tmp_path, monkeypatch, arch):
    """Each architecture through both packages' tasks: the same model config
    field by field (a transformer encoder; the recipe's relative positions
    through ``model.encoder_pos_type``), the port model built from it (on
    the meta device), a ``model_cfg.json`` the port's train CLI writes
    resolved alike by both packages, and the task's decoders for the CE
    criterion: the greedy valid decoder and the beam search, both on the
    transformer's caches."""
    from espresso_tpu import config as jax_config
    from espresso_tpu.tasks import setup_task as jax_setup_task
    from espresso_tpu_torch import config as port_config
    from espresso_tpu_torch.cli.train import write_model_cfg
    from espresso_tpu_torch.tasks import setup_task as port_setup_task

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    d = str(tmp_path)
    with open(f"{d}/dict.txt", "w") as f:
        f.writelines(f"u{i} 1\n" for i in range(20))
    argv = [f"dataset.data={d}", f"model.name={arch}", "model.encoder_pos_type=relative",
            "criterion.name=label_smoothed_cross_entropy_v2", f"checkpoint.save_dir={d}/ckpt"]
    jt = jax_setup_task(jax_config.parse_config(argv))
    pt = port_setup_task(port_config.parse_config(argv))
    jt.build_model()
    _, got = pt.build_model_config()
    assert port_config.config_to_dict(got) == jax_config.config_to_dict(jt.model_cfg)
    assert got.encoder_layer_type == "transformer" and got.encoder_pos_type == "relative"
    with torch.device("meta"):
        model = SpeechTransformerModel(got)
    assert isinstance(pt.build_valid_decoder(model), SimpleGreedyDecoder)
    assert isinstance(make_adapter(model), TransformerDecoderAdapter)
    assert isinstance(pt.build_generator(model).adapter, TransformerDecoderAdapter)
    write_model_cfg(f"{d}/ckpt", model, pt.cfg, got)
    dec = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt", "model.decoder_layers=2"]
    jcfg = jax_config.apply_saved_model_cfg(jax_config.parse_config(dec), dec)
    pcfg = port_config.apply_saved_model_cfg(port_config.parse_config(dec), dec)
    assert pcfg.model == jcfg.model and pcfg.model["decoder_layers"] == 2
    assert pcfg.criterion.name == jcfg.criterion.name == "label_smoothed_cross_entropy_v2"


def test_train_state_with_tied_embedding_resumes_bit_equal(small, tmp_path):
    """The tied embedding is one slot of the flat masters, of adam's moments
    and of the checkpoint (one ``params/embed_tokens/embedding``); three
    train steps at dropout 0.1 (the encoder's attention dropout seeded from
    the step's generator) equal two, a save, a restore into a fresh model
    and a third, bit for bit."""
    _, variables, _, frames, target, prev = small
    cfg = EspressoConfig()
    cfg.common.dtype = "float32"
    cfg.criterion.name = "label_smoothed_cross_entropy_v2"
    kw = {**SMALL, "dropout": 0.1}
    batch = {k: _t(v)[None] for k, v in (("src_frames", frames), ("src_lengths", LENS), ("target", target),
                                         ("prev_output_tokens", prev))}
    batch["weight"] = torch.ones(1, B)

    def fresh():
        model = load_jax_variables(SpeechTransformerModel(SpeechTransformerConfig(**kw)), variables)
        opt, _ = trainer.build_optimizer(cfg)
        state = trainer.create_train_state(model, opt, cfg)
        return model, state, trainer.make_train_step(model, build_criterion(cfg.criterion, _Task()), opt, cfg)

    model, state, step = fresh()
    assert state.params.numel() == sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    ckpt.save_checkpoint_state(str(tmp_path / "ck"), ckpt.train_state_arrays(state, model, gen), {})
    state, m3 = step(state, batch, gen)
    tree, _ = ckpt.load_checkpoint_state(str(tmp_path / "ck"))
    assert [k for k in ckpt.flatten_tree(tree["params"]) if "embed" in k] == ["embed_tokens/embedding"]
    model2, state2, step2 = fresh()
    gen2 = torch.Generator()
    ckpt.restore_train_state(state2, model2, tree, gen2)
    state2, r3 = step2(state2, batch, gen2)
    assert state2.step == state.step == 3 and int(state2.opt_state.count) == 3
    assert torch.equal(state2.params, state.params) and torch.equal(m3["loss"], r3["loss"])
    for name in ("mu", "nu"):
        assert torch.equal(getattr(state2.opt_state, name), getattr(state.opt_state, name))


def test_refused_options_raise(small, tmp_path):
    """What the port does not carry raises NotImplementedError: rotary and
    learned positions, LayerDrop and BASE layers; a per-row cache index
    (ROADMAP queue A item 2); ``generation.print_alignment`` for this
    model (item 3, tools/plot)."""
    from espresso_tpu_torch.cli import speech_recognize
    from utils import make_corpus

    for over in (dict(encoder_pos_type="rotary"), dict(encoder_learned_pos=True), dict(encoder_layerdrop=0.1),
                 dict(decoder_layerdrop=0.1), dict(base_layers=1)):
        with pytest.raises(NotImplementedError):
            SpeechTransformerModel(SpeechTransformerConfig(**{**SMALL, **over}))
    model = small[2]
    with torch.no_grad():
        enc = model.encode(_t(small[3]), _t(LENS))
        cache = model.init_cache(enc, 4)
        layer = model.decoder_layers[0]
        with pytest.raises(NotImplementedError, match="queue A item 2"):
            layer(torch.zeros(B, 1, D), enc.encoder_out, enc.encoder_padding_mask, cache=cache[0],
                  cache_index=torch.zeros(B, dtype=torch.long))
    d = str(tmp_path)
    make_corpus(d, "test", num_utts=2, feat_dim=F, seed=0)
    argv = [f"dataset.data={d}", f"dataset.feat_dim={F}", f"checkpoint.save_dir={d}/none",
            "criterion.name=label_smoothed_cross_entropy_v2", "model.name=speech_transformer_wsj",
            "model.encoder_layers=1", "model.decoder_layers=1", "model.encoder_embed_dim=16",
            "model.decoder_embed_dim=16", "model.encoder_ffn_dim=16", "model.decoder_ffn_dim=16",
            "generation.print_alignment=true", "common.dtype=float32"]
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        speech_recognize.main(argv, device="cpu")


def test_chip_smoke_recipe_is_the_yaml():
    """chip_smoke.TRANSFORMER_RECIPE (written out for a card machine
    without PyYAML) is examples/asr_librispeech/transformer_librispeech.yaml."""
    import sys

    from espresso_tpu_torch import config as port_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    yaml_cfg = port_config.parse_config(["--config", f"{root}/examples/asr_librispeech/transformer_librispeech.yaml"])
    assert port_config.config_to_dict(port_config.load_config_dict(chip_smoke.TRANSFORMER_RECIPE)) == \
        port_config.config_to_dict(yaml_cfg)
