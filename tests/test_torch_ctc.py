"""The port's CTC slice against JAX: the loss and its gradient, the
encoder-only models, the criterion, the greedy and prefix-beam decoders,
the task's routing and the configs.

The models are small (a 2-layer conv frontend on 12-dim features, 2
transformer encoder layers of 64 with relative positions, ffn 128, 4 heads;
a 2-layer bi-LSTM of 16; V = 40), drawn in numpy on the shapes of JAX's
init (``jax.eval_shape``: no init compile) and carried into the port by
``bridge.load_jax_variables``. fp32 on the CPU (the port's kernel wrappers
run their plain versions), torch on one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_o0
from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.criterions import build_criterion as jax_build_criterion
from espresso_tpu.decode.ctc_decoder import CTCGreedyDecoder as JaxGreedy
from espresso_tpu.decode.ctc_decoder import CTCPrefixBeamSearchDecoder as JaxPrefixBeam
from espresso_tpu.models import encoder_models as jax_models
from espresso_tpu.models.speech_lstm import SpeechLSTMConfig as JaxLSTMConfig
from espresso_tpu.models.speech_transformer import SpeechTransformerConfig as JaxSTConfig
from espresso_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from espresso_tpu.registry import apply_architecture as jax_apply_architecture
from espresso_tpu_torch.bridge import jax_state_dict, load_jax_variables
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import CTCCriterion
from espresso_tpu_torch.decode.ctc_decoder import CTCGreedyDecoder, CTCPrefixBeamSearchDecoder
from espresso_tpu_torch.models import encoder_models
from espresso_tpu_torch.models.speech_lstm import SpeechLSTMConfig
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.ops.ctc import ctc_loss
from espresso_tpu_torch.registry import apply_architecture

F, B, T, V = 12, 3, 32, 40
LENS = np.array([32, 21, 9], np.int32)  # 8, 6 and 3 encoder frames (4x subsampling)
BLANK, PAD, EOS = 0, 1, 2
FRONT = dict(conv_channels=(4, 8), conv_kernel_sizes=((3, 3), (3, 3)), conv_strides=((2, 2), (2, 2)),
             dropout=0.0)
ENCODERS = {
    "transformer": (jax_models.TransformerEncoderModelConfig, JaxSTConfig,
                    encoder_models.TransformerEncoderModelConfig, SpeechTransformerConfig,
                    dict(encoder_embed_dim=64, encoder_ffn_dim=128, encoder_layers=2, encoder_heads=4,
                         encoder_pos_type="relative", **FRONT)),
    "lstm": (jax_models.LSTMEncoderModelConfig, JaxLSTMConfig, encoder_models.LSTMEncoderModelConfig,
             SpeechLSTMConfig, dict(encoder_hidden_size=16, encoder_layers=2, **FRONT)),
}
# fp32 on the CPU, summed in other orders by each framework: the loss and
# its gradient to 1e-5 (relative and absolute); logits of O(1) to 1e-4;
# decode scores (sums of a few hundred log-probs) to 1e-5 relative; a train
# step's loss to 1e-5 relative and each gradient to 1e-4 of the model's
# largest (a conv bias before batch norm has a gradient of 0 in exact
# arithmetic, rounding noise in each framework)
LOSS_TOL, LOGIT_ATOL, SCORE_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dictionary:
    def blank(self):
        return BLANK

    def pad(self):
        return PAD

    def eos(self):
        return EOS


class _Task:
    dictionary = _Dictionary()


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- the loss -----------------------------------------------------------------

# (logit lengths, targets, target lengths) of 4 rows over T = 12 frames,
# V = 7, the blank 0
LOSS_CASES = {
    # a label repeated (no skip between the two), a frame-full row
    "repeats": ([12, 12, 10, 8], [[3, 3, 4, 4, 5], [2, 5, 5, 5, 1], [6, 6, 6, 0, 0], [1, 2, 1, 2, 0]],
                [5, 4, 3, 4]),
    # an empty target: the all-blank path alone
    "empty_target": ([12, 9, 12, 5], [[3, 4, 0, 0, 0], [0, 0, 0, 0, 0], [5, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
                     [2, 0, 1, 0]),
    # a target too long for its frames (4 frames, 3 repeats need 5): with
    # zero_infinity its loss and its gradient are 0
    "too_long": ([12, 4, 12, 3], [[1, 2, 3, 4, 5], [3, 3, 3, 0, 0], [6, 5, 4, 0, 0], [2, 3, 4, 5, 6]],
                 [5, 3, 3, 5]),
    # rows past their length: the padding frames hold large logits that
    # must change nothing
    "past_length": ([6, 12, 2, 9], [[1, 2, 0, 0, 0], [4, 1, 4, 1, 4], [5, 0, 0, 0, 0], [2, 2, 0, 0, 0]],
                    [2, 5, 1, 2]),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_ctc_loss_and_gradient_match_jax(case):
    """Per-row losses and the gradient of their sum with respect to the
    logits, against JAX's ``ctc_loss`` and ``jax.grad``."""
    lengths, targets, tlens = (np.asarray(a, np.int32) for a in LOSS_CASES[case])
    rng = np.random.default_rng(len(case))
    logits = rng.standard_normal((4, 12, 7)).astype(np.float32) * 2
    if case == "past_length":
        logits[np.arange(12)[None, :] >= lengths[:, None]] = 50.0
    run = jax_o0.jit(jax.value_and_grad(
        lambda x: (lambda r: (r.sum(), r))(jax_ctc_loss(x, lengths, targets, tlens, blank=BLANK)), has_aux=True))
    (_, want), want_grad = jax.device_get(run(logits))
    x = _t(logits).requires_grad_()
    got = ctc_loss(x, _t(lengths), _t(targets), _t(tlens), blank=BLANK)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=LOSS_TOL, atol=LOSS_TOL)
    if case == "too_long":
        assert want[1] == want[3] == 0.0 and not x.grad[1].any() and not x.grad[3].any()
    if case == "past_length":
        assert not x.grad[np.arange(12)[None, :] >= lengths[:, None]].any()


def test_criterion_strips_eos_as_jax_does():
    """The criterion's EOS strip (targets with EOS where the collation put
    one: to pad, ``tgt_lengths`` less the count), its weighted sum,
    ``ntokens`` and sample size, against JAX's criterion on the same
    logits (a model that returns them)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 10, V)).astype(np.float32)
    target = np.array([[5, 6, 7, EOS], [8, 8, EOS, PAD], [EOS, PAD, PAD, PAD]], np.int32)
    batch = {"src_frames": np.zeros((3, 10, F), np.float32), "src_lengths": np.array([10, 8, 6], np.int32),
             "target": target, "prev_output_tokens": target, "tgt_lengths": np.array([4, 3, 1], np.int32),
             "weight": np.array([1.0, 1.0, 0.5], np.float32)}
    jcfg = JaxConfig()
    jcfg.criterion.name = "ctc_loss"
    jmodel = type("M", (), {"apply": staticmethod(lambda v, x, lens, *a, **kw: (
        jnp.asarray(logits), type("E", (), {"src_lengths": lens})()))})
    jloss, jsize, jlog, _ = jax_build_criterion(jcfg.criterion, _Task())(jmodel, {}, batch)

    class Model(torch.nn.Module):
        def forward(self, frames, lens):
            return _t(logits), type("E", (), {"src_lengths": lens})()

    loss, size, logging = CTCCriterion(EspressoConfig().criterion, _Dictionary())(
        Model(), {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    assert logging["ntokens"].item() == float(jlog["ntokens"]) == 5.0 and size.item() == float(jsize)
    assert CTCCriterion.logging_keys == ("loss", "ntokens")


# -- the models -----------------------------------------------------------------


def _draw(rng):
    """Init-like values for a flax leaf: kernels at 1/sqrt(fan-in), batch
    variances in [0.5, 1.5], layer-norm scales near 1, the rest at 0.3."""

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        scale = 1 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in name else 0.3
        a = rng.standard_normal(s.shape) * scale
        return np.asarray(1.0 + 0.1 * a if name == "scale" else a, np.float32)

    return draw


def _models(kind, seed):
    """(JAX model, its variables, the port model in eval mode, frames) of
    the small ``kind`` encoder model."""
    jcls, jenc, pcls, penc, enc = ENCODERS[kind]
    rng = np.random.default_rng(seed)
    jmodel = getattr(jax_models, {"transformer": "SpeechTransformerEncoderModel",
                                  "lstm": "SpeechLSTMEncoderModel"}[kind])(
        jcls(feat_dim=F, vocab_size=V, encoder=jenc(**enc)))
    frames = rng.standard_normal((B, T, F)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), frames, LENS)
    variables = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    pmodel = {"transformer": encoder_models.SpeechTransformerEncoderModel,
              "lstm": encoder_models.SpeechLSTMEncoderModel}[kind](pcls(feat_dim=F, vocab_size=V,
                                                                       encoder=penc(**enc)))
    return jmodel, variables, load_jax_variables(pmodel, variables).eval(), frames


@pytest.fixture(scope="module", params=list(ENCODERS))
def model_run(request):
    """Each encoder model's JAX logits and output lengths, compiled once."""
    jmodel, variables, model, frames = _models(request.param, seed=1)
    logits, enc = jax.device_get(jax_o0.jit(lambda v, x: jmodel.apply(v, x, LENS))(variables, frames))
    return request.param, jmodel, variables, model, frames, logits, enc.src_lengths


def test_encoder_models_match_jax(model_run):
    """The transformer (relative positions: B1's plain version) and the
    bi-LSTM encoder models' logits and output lengths in eval mode."""
    _, _, _, model, frames, want, want_lens = model_run
    with torch.no_grad():
        logits, enc = model(_t(frames), _t(LENS))
    np.testing.assert_array_equal(enc.src_lengths.numpy(), want_lens)
    for b, n in enumerate(want_lens):
        np.testing.assert_allclose(logits[b, :n].numpy(), want[b, :n], atol=LOGIT_ATOL)


def test_greedy_decoder_matches_jax(model_run):
    """CTC's best path on each model: the same tokens, the scores (the sum
    of each frame's best log-prob) within SCORE_RTOL; the host's collapse
    of one path is JAX's exactly."""
    kind, jmodel, variables, model, frames, _, _ = model_run
    batch = {"src_frames": frames, "src_lengths": LENS}
    with jax_o0.jit_o0():
        want = JaxGreedy(jmodel, _Dictionary()).decode(variables, batch)
    got = CTCGreedyDecoder(model, _Dictionary()).decode(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0]["tokens"], w[0]["tokens"], err_msg=kind)
        assert g[0]["tokens"].dtype == np.int32
        np.testing.assert_allclose(g[0]["score"], w[0]["score"], rtol=SCORE_RTOL)


def test_prefix_beam_decoder_on_a_model_matches_jax(model_run):
    """The prefix beam search (beam 5) through each model's log-probs:
    each n-best's tokens, the scores within SCORE_RTOL; an LM changes no
    hypothesis (JAX's search never reads it)."""
    _, jmodel, variables, model, frames, _, _ = model_run
    batch = {"src_frames": frames, "src_lengths": LENS}
    with jax_o0.jit_o0():
        want = JaxPrefixBeam(jmodel, _Dictionary(), beam_size=5).decode(variables, batch)
    got = CTCPrefixBeamSearchDecoder(model, _Dictionary(), beam_size=5).decode(batch)
    fused = CTCPrefixBeamSearchDecoder(model, _Dictionary(), beam_size=5, lm=model, lm_weight=0.5).decode(batch)
    for g, w, f in zip(got, want, fused):
        assert [list(h["tokens"]) for h in g] == [list(h["tokens"]) for h in w] == [list(h["tokens"]) for h in f]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w], rtol=SCORE_RTOL)
        assert [h["score"] for h in g] == [h["score"] for h in f]


@pytest.mark.parametrize("T_,V_,beam,peak", [(20, 12, 4, 3.0), (30, 30, 10, 2.0), (16, 6, 3, 1.0),
                                            (12, 9, 1, 4.0)])
def test_prefix_search_equals_jax_exactly(T_, V_, beam, peak):
    """The same seeded [T, V] log-probs through JAX's ``_decode_one`` and
    the port's: equal n-best lists, tokens and scores as floats (the host
    part is JAX's, copied). Frames with repeated peaks exercise the repeat
    rule; ``peak`` sets how many tokens pass the 1e-5 pruning."""
    rng = np.random.default_rng(T_ + V_)
    x = rng.standard_normal((T_, V_)) * peak
    x[1::3] = x[0::3][: len(x[1::3])]  # repeats of the frame before
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    want = JaxPrefixBeam(None, _Dictionary(), beam_size=beam)._decode_one(lp)
    got = CTCPrefixBeamSearchDecoder(None, _Dictionary(), beam_size=beam)._decode_one(lp)
    assert [list(t) for t, _ in got] == [list(t) for t, _ in want]
    assert [s for _, s in got] == [s for _, s in want]
    assert len(got) == min(beam, len(got)) and len(got) >= 1


# -- one train step ---------------------------------------------------------------


def test_train_step_gradients_match_jax():
    """The CTC criterion on the transformer model in train mode at dropout
    0 (its attention through B2/B3's plain versions, the frontend's batch
    norm on the batch's statistics): the loss and every parameter's
    gradient against JAX's criterion and VJP."""
    jmodel, variables, model, frames = _models("transformer", seed=2)
    rng = np.random.default_rng(2)
    target = rng.integers(3, V, (B, 4)).astype(np.int32)
    target[1, 3], target[2, 1:] = EOS, PAD
    batch = {"src_frames": frames, "src_lengths": LENS, "target": target, "prev_output_tokens": target,
             "tgt_lengths": np.array([4, 4, 1], np.int32), "weight": np.array([1.0, 1.0, 1.0], np.float32)}
    jcfg = JaxConfig()
    jcfg.criterion.name = "ctc_loss"
    crit = jax_build_criterion(jcfg.criterion, _Task())

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, frames, LENS,
                              train=True, mutable=["batch_stats"])
        model_ = type("M", (), {"apply": staticmethod(lambda v, *a, **kw: out)})
        res = crit(model_, {}, batch)
        return res[0], res[2]

    (jloss, jlog), jgrads = jax.device_get(jax_o0.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"]))
    model.train()
    loss_t, size, logging = CTCCriterion(EspressoConfig().criterion, _Dictionary())(
        model, {k: _t(v) for k, v in batch.items()})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(jloss), rtol=LOSS_TOL)
    assert logging["ntokens"].item() == float(jlog["ntokens"]) == 8.0 and size.item() == 8.0
    want = jax_state_dict({"params": jgrads})
    scale = max(np.abs(w).max() for w in want.values())
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale, err_msg=name)


# -- configs and the task ------------------------------------------------------------


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_sections_and_presets_match_jax():
    """The criterion section's CTC fields, the optimizer section (its
    ``groups`` too), both encoder models' configs and the
    ``transformer_ctc_librispeech`` preset: JAX's names and defaults."""
    want, got = _fields(JaxConfig().criterion), _fields(EspressoConfig().criterion)
    assert set(got) <= set(want) and all(got[k] == want[k] for k in got)
    assert "zero_infinity" in set(got)
    assert _fields(EspressoConfig().optimizer) == _fields(JaxConfig().optimizer)
    for jcls, _, pcls, _, _ in ENCODERS.values():
        w, g = _fields(jcls()), _fields(pcls())
        assert _fields(g.pop("encoder")) == _fields(w.pop("encoder")) and g == w
    w, g = jax_models.TransformerEncoderModelConfig(), encoder_models.TransformerEncoderModelConfig()
    jax_apply_architecture("transformer_ctc_librispeech", w)
    apply_architecture("transformer_ctc_librispeech", g)
    assert _fields(g.encoder) == _fields(w.encoder) and g.encoder.encoder_layers == 12


def test_task_routes_ctc_as_jax_does(tmp_path, monkeypatch):
    """With ``criterion.name=ctc_loss`` both tasks load the dictionary with
    a blank (bos), collate without EOS (the same arrays), resolve the
    recipe's arch to the same model config, and the port's task builds the
    CTC criterion, the greedy valid decoder, the greedy generator at beam 1
    and the prefix beam search above it."""
    from espresso_tpu import config as jax_config
    from espresso_tpu.tasks import setup_task as jax_setup_task
    from espresso_tpu_torch import config as port_config
    from espresso_tpu_torch.tasks import setup_task as port_setup_task
    from utils import make_corpus

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    d = str(tmp_path)
    make_corpus(d, "train", num_utts=6, feat_dim=F, seed=2)
    argv = [f"dataset.data={d}", "criterion.name=ctc_loss", f"dataset.feat_dim={F}",
            "model.name=transformer_ctc_librispeech", "model.encoder.encoder_pos_type=relative"]
    jt, pt = jax_setup_task(jax_config.parse_config(argv)), port_setup_task(port_config.parse_config(argv))
    assert len(jt.dictionary) == len(pt.dictionary) and pt.dictionary.blank() == jt.dictionary.blank()
    assert not jt.autoregressive and not pt.autoregressive
    jds, pds = jt.load_dataset("train"), pt.load_dataset("train")
    kw = dict(max_tokens=200, max_sentences=None, num_buckets=2, shuffle=False)
    for js, ps in zip(jds.make_batch_specs(**kw), pds.make_batch_specs(**kw)):
        jb, pb = jds.collate(js), pds.collate(ps)
        for k in ("src_frames", "src_lengths", "prev_output_tokens", "target", "tgt_lengths", "weight"):
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert not (pb["target"] == pt.dictionary.eos()).any()
    jt.build_model()
    name, mcfg = pt.build_model_config()
    assert name == "speech_transformer_encoder_model"
    assert _fields(mcfg.encoder) == _fields(jt.model_cfg.encoder)
    assert {k: v for k, v in _fields(mcfg).items() if k != "encoder"} == \
        {k: v for k, v in _fields(jt.model_cfg).items() if k != "encoder"}
    assert isinstance(pt.build_criterion(), CTCCriterion)
    model = pt.build_model(device="meta")
    assert isinstance(pt.build_valid_decoder(model), CTCGreedyDecoder)
    gen = pt.cfg.generation
    for beam, cls in ((1, CTCGreedyDecoder), (10, CTCPrefixBeamSearchDecoder)):
        gen.beam = beam
        assert type(pt.build_generator(model, gen, lm=None)) is cls


def test_chip_smoke_ctc_recipe_is_the_yaml():
    """chip_smoke.CTC_RECIPE (written out for a card machine without
    PyYAML) is examples/asr_librispeech/transformer_ctc_librispeech.yaml."""
    import os
    import sys

    from espresso_tpu_torch import config as port_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    yaml_cfg = port_config.parse_config(
        ["--config", f"{root}/examples/asr_librispeech/transformer_ctc_librispeech.yaml"])
    assert port_config.config_to_dict(port_config.load_config_dict(chip_smoke.CTC_RECIPE)) == \
        port_config.config_to_dict(yaml_cfg)
