"""The port's attention LSTM encoder-decoder (``speech_lstm``) against JAX.

A small ``SpeechLSTMModel`` (a 2-layer conv frontend on 12-dim features,
a 2-layer bi-LSTM encoder of 16, a 2-layer decoder of 16, attention 12,
output embedding 24) is drawn in numpy on the shapes of JAX's init
(``jax.eval_shape``: no init compile) and carried into the port by
``bridge.load_jax_variables``. Held to JAX in fp32 on the CPU: the
encoder over ragged lengths and the teacher-forced logits (Bahdanau, Luong
and no attention; residual sums on and off; shared and unshared output
embeddings), both attention modules with a padding mask, the decoder under
scheduled sampling given JAX's coins, one and two train steps of
``label_smoothed_cross_entropy_v2`` (uniform and temporal) with adam and
clipping, the greedy decoder, and the beam search with and without LSTM-LM
shallow fusion (``eos_factor``, ``len_penalty``, ``min_len`` and a prefix;
the fused case at V = 5,003). Then the bf16 paths of both at the
librispeech widths (one encoder layer, two decoder layers), and the
options the port refuses. Torch runs on one thread.
"""

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
from espresso_tpu.models.speech_lstm import SpeechLSTMConfig as JaxConfigLSTM
from espresso_tpu.models.speech_lstm import SpeechLSTMModel as JaxModel
from espresso_tpu.modules.speech_attention import BahdanauAttention as JaxBahdanau
from espresso_tpu.modules.speech_attention import LuongAttention as JaxLuong
from espresso_tpu.tools.scheduled_sampling import ScheduledSamplingRateScheduler as JaxSS
from espresso_tpu.train import trainer as jax_trainer
from espresso_tpu_torch.bridge import flax_paths, jax_state_dict, load_jax_variables, to_flax_layout
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import build_criterion
from espresso_tpu_torch.decode.api import make_adapter
from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
from espresso_tpu_torch.decode.greedy import SimpleGreedyDecoder
from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
from espresso_tpu_torch.models.speech_lstm import SpeechLSTMConfig, SpeechLSTMModel
from espresso_tpu_torch.modules.dropout import set_dropout_generator
from espresso_tpu_torch.modules.lstm import LSTM
from espresso_tpu_torch.modules.speech_attention import BahdanauAttention, LuongAttention
from espresso_tpu_torch.tools.scheduled_sampling import ScheduledSamplingRateScheduler
from espresso_tpu_torch.train import trainer

# XLA's compile of each JAX function grows with the scans it unrolls and the
# frontend's layers: short sequences, a 2-layer frontend (4x subsampling)
F, B, T, U, V = 12, 3, 16, 4, 40
LENS = np.array([16, 11, 5], np.int32)  # 4, 3 and 2 encoder frames
SMALL = dict(
    feat_dim=F, conv_channels=(4, 8), conv_kernel_sizes=((3, 3), (3, 3)),
    conv_strides=((2, 2), (2, 2)), encoder_hidden_size=16, encoder_layers=2,
    decoder_embed_dim=8, decoder_hidden_size=16, decoder_out_embed_dim=24, decoder_layers=2,
    attention_dim=12, dropout=0.0,
)
EOS, PAD = 2, 1
# fp32 on the CPU, summed in other orders by each framework: activations and
# logits of O(1) to 1e-5; beam and greedy scores (sums of a few log-probs) to
# 1e-5 relative
ATOL, SCORE_RTOL = 1e-5, 1e-5
# the train steps: the loss and the gradient norm to 1e-5 relative; a weight
# moves by ~lr a step, so 2e-6 absolute is ~0.02 % of one step's move; adam's
# epsilon at 1e-4 keeps the update a smooth function of the gradient (the
# frontend's convolution biases feed a batch norm: their gradient is 0 in
# exact arithmetic and rounding noise in each framework, which adam at the
# default 1e-8 would turn into ~lr moves either way)
STEP_RTOL, P_ATOL, STATS_ATOL, ADAM_EPS, LR, CLIP = 1e-5, 2e-6, 1e-5, 1e-4, 0.01, 0.5
# the bf16 paths at librispeech widths: both round at other points (XLA
# fuses elementwise chains in f32, torch rounds after each op). The encoder
# output (|x| < 1) read 0.0049 apart, under one bf16 ulp at 0.5-1 (0.0039 to
# 0.0078); the logits (|x| up to 1.7) 0.0156, one ulp at 1-2. Bounds at 2.5
# and 4 ulps; a fault moves either by O(1). A greedy token is held to be
# JAX's argmax up to a near-tie: its JAX logit within BF16_LOGIT_ATOL of
# the step's best (in one draw, one of 6 steps was such a tie)
BF16_ENC_ATOL, BF16_LOGIT_ATOL = 0.02, 0.0625
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


def _draw(rng, peak=1.0):
    """Init-like values for a flax leaf: kernels (the LSTM layers'
    ``hh_kernel`` too) at 1/sqrt(fan-in), batch
    variances in [0.5, 1.5], the rest at 0.3; ``fc_out`` times ``peak``."""

    def draw(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        scale = 1 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in names[-1] else 0.3
        a = rng.standard_normal(s.shape) * scale
        if names[-1] == "scale":
            a = 1.0 + 0.1 * a
        if "fc_out" in names:
            a = a * peak
        return np.asarray(a, np.float32)

    return draw


def _inputs(rng, vocab=V, frames=T, tokens=U):
    x = rng.standard_normal((B, frames, F)).astype(np.float32)
    target = rng.integers(3, vocab, (B, tokens)).astype(np.int32)
    target[1, tokens - 2:], target[2, 2:] = PAD, PAD
    target[0, -1], target[1, tokens - 3], target[2, 1] = EOS, EOS, EOS
    prev = np.concatenate([np.full((B, 1), EOS, np.int32), target[:, :-1]], 1)
    return x, target, prev


def _models(seed, vocab=V, peak=1.0, frames=T, tokens=U, **over):
    """(JAX model, its variables, the port model in eval mode, frames,
    target, prev_output_tokens) of SMALL with ``over``."""
    rng = np.random.default_rng(seed)
    kw = {**SMALL, "vocab_size": vocab, **over}
    jmodel = JaxModel(JaxConfigLSTM(**kw))
    frames, target, prev = _inputs(rng, vocab, frames, tokens)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), frames, LENS, prev)
    variables = jax.tree_util.tree_map_with_path(_draw(rng, peak), shapes)
    model = load_jax_variables(SpeechLSTMModel(SpeechLSTMConfig(**kw)).eval(), variables)
    return jmodel, variables, model, frames, target, prev


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def small():
    """The Bahdanau model (output peaked x3, so that greedy and beam
    choices are not near-ties) that most cases share."""
    return _models(1, peak=3.0)


@pytest.mark.parametrize("over", [
    None,
    dict(attention_type="luong", encoder_residual=True, decoder_residual=True,
         share_decoder_input_output_embed=True, decoder_out_embed_dim=8),
    dict(attention_type="none", decoder_residual=True),
], ids=["bahdanau", "luong_residual_shared", "none_residual"])
def test_encoder_and_teacher_forced_logits_match_jax(small, over):
    """The encoder output at every position (0 past each length) and the
    teacher-forced logits; the flax tree loads leaf for leaf (additional_fc
    present or not, fc_out or the shared embedding)."""
    jmodel, variables, model, frames, _, prev = small if over is None else _models(2, **over)
    over = over or {"attention_type": "bahdanau"}
    params = variables["params"]["decoder"]
    assert ("fc_out" in params) != over.get("share_decoder_input_output_embed", False)
    assert ("attention" in params) == (over["attention_type"] != "none")
    want, jenc = jax_o0.jit(jmodel.apply)(variables, frames, LENS, prev)
    with torch.no_grad():
        got, enc = model(_t(frames), _t(LENS), _t(prev).long())
    np.testing.assert_array_equal(enc.src_lengths.numpy(), np.asarray(jenc.src_lengths))
    np.testing.assert_allclose(enc.encoder_out.numpy(), np.asarray(jenc.encoder_out), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bilstm_backward_direction_stays_within_each_length():
    """Garbage past a row's length changes nothing at its valid positions
    (the backward direction starts at the row's own last frame), and the
    output there is 0."""
    torch.manual_seed(0)
    lstm = LSTM(6, 5, num_layers=2, bidirectional=True, residual=True).eval()
    lengths = torch.tensor([9, 4, 1])
    x = torch.randn(3, 9, 6)
    noisy = x.clone()
    valid = torch.arange(9)[None, :] < lengths[:, None]
    noisy[~valid] = 100 * torch.randn(int((~valid).sum()), 6)
    with torch.no_grad():
        a, b = lstm(x, lengths), lstm(noisy, lengths)
    assert torch.equal(a, b) and not a[~valid].any() and a[valid].abs().min() > 0


@pytest.mark.parametrize("kind", ["bahdanau", "luong"])
def test_attention_matches_jax(kind):
    """Context and weights over keys with a padding mask (one row's last
    key only, one row whole)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 10)).astype(np.float32)
    keys = rng.standard_normal((3, 7, 14)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([7, 4, 1])[:, None]
    jmod = JaxBahdanau(9) if kind == "bahdanau" else JaxLuong()
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), q, keys, mask)
    variables = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    port = BahdanauAttention(10, 14, 9) if kind == "bahdanau" else LuongAttention(10, 14)
    load_jax_variables(port, variables)
    want = jmod.apply(variables, q, keys, mask)
    with torch.no_grad():
        got = port(_t(q), _t(keys), _t(mask))
        again = port(_t(q), _t(keys), _t(mask), port.project_keys(_t(keys)))
    for g, a, w in zip(got, again, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        assert torch.equal(g, a)
    assert not got[1][~_t(mask)].any()


def test_scheduled_sampling_decoder_matches_jax_given_its_coins(small):
    """JAX's scanned decoder at ss_prob 0.6 with a coin array, and the
    port's ``decode_sequence`` given the same coins in train mode: the same
    fed tokens (the argmax of each step where the coin rejects the teacher)
    and the logits."""
    jmodel, variables, model, frames, _, prev = small
    coin = np.random.default_rng(4).uniform(size=(U, B)).astype(np.float32)
    ss = 0.6
    assert 0 < (coin >= ss).sum() < coin.size

    def jax_decode(mdl, tokens, coin, ss_prob):
        enc = mdl.encoder(jnp.asarray(frames), jnp.asarray(LENS))
        carry = mdl.init_decoder_carry(B)
        _, (logits, _, _) = mdl.decoder(carry, tokens.T, coin, enc.encoder_out,
                                        enc.encoder_padding_mask, False, ss_prob)
        return jnp.moveaxis(logits, 0, 1)

    want = jax_o0.jit(lambda v, p, c, ss: jmodel.apply(v, p, c, ss, method=jax_decode))(
        variables, prev, coin, jnp.float32(ss))
    with torch.no_grad():
        enc = model.encode(_t(frames), _t(LENS))
        model.train()  # dropout is 0: train mode turns the sampling on
        got, _ = model.decode_sequence(_t(prev).long(), enc, ss_prob=ss, coin=_t(coin))
        # the tokens it fed: the teacher's where coin < ss, else the previous
        # step's argmax (0 before the first)
        argmax = np.concatenate([np.zeros((B, 1), np.int64), got.argmax(-1).numpy()[:, :-1]], 1)
        fed = np.where(coin.T < ss, prev, argmax)
        replay, _ = model.eval().decode_sequence(_t(fed).long(), enc)
    model.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(replay.numpy(), got.numpy(), atol=ATOL)


def test_scheduled_sampling_rate():
    """The scheduler gives JAX's rates; in train mode the model draws its
    coins [U, B] uniform from the step's generator (the one
    ``set_dropout_generator`` sets), so the teacher's token is fed at the
    rate: over 12,000 coins within 0.02 of it (~5 standard deviations)."""
    for probs, start in (([1.0], 1), ([0.9], 1), ([0.9, 0.8, 0.7], 2), ([1.0, 0.5], 3)):
        j, p = JaxSS(probs, start), ScheduledSamplingRateScheduler(probs, start)
        assert [p.step(e) for e in range(1, 7)] == [j.step(e) for e in range(1, 7)]
    torch.manual_seed(5)
    model = SpeechLSTMModel(SpeechLSTMConfig(**{**SMALL, "vocab_size": V})).train()
    set_dropout_generator(model, torch.Generator().manual_seed(6))
    n, u, ss = 400, 30, 0.7
    prev = torch.randint(3, V, (n, u))
    with torch.no_grad():
        enc = model.encode(torch.randn(n, 12, F), torch.full((n,), 12))
        drawn, _ = model.decode_sequence(prev, enc, ss_prob=ss)
        coin = torch.rand((u, n), generator=torch.Generator().manual_seed(6))
        replay, _ = model.decode_sequence(prev, enc, ss_prob=ss, coin=coin)
    assert torch.equal(drawn, replay)
    assert abs(float((coin < ss).float().mean()) - ss) < 0.02


def _train_configs(smoothing):
    jcfg, pcfg = JaxConfig(), EspressoConfig()
    for cfg in (jcfg, pcfg):
        cfg.common.dtype = "float32"
        cfg.criterion.name = "label_smoothed_cross_entropy_v2"
        cfg.criterion.label_smoothing = 0.1
        cfg.criterion.smoothing_type = smoothing
        cfg.optimization.clip_norm = CLIP
        cfg.optimization.lr = [LR]
        cfg.optimizer.adam_eps = ADAM_EPS
    return jcfg, pcfg


def _train_batch(frames, target, prev):
    """Two microbatches (the second the first's rows reversed, one of them
    of weight 0), pads and eos inside."""
    lens = np.array([16, 11, 7], np.int32)
    batch = {
        "src_frames": np.stack([frames, frames[::-1].copy()]),
        "src_lengths": np.stack([lens, lens[::-1].copy()]),
        "target": np.stack([target, target[::-1].copy()]),
        "prev_output_tokens": np.stack([prev, prev[::-1].copy()]),
        "weight": np.array([[1, 1, 1], [1, 0, 1]], np.float32),
    }
    batch["tgt_lengths"] = (batch["target"] != PAD).sum(-1).astype(np.int32)
    return batch


SMOOTHINGS = ("uniform", "temporal")


@pytest.fixture(scope="module")
def train_run():
    """JAX's side of two train steps for each smoothing type, from one
    compiled function: the model's forward in train mode (the batch
    statistics carried from one microbatch to the next, as JAX's step
    carries them) and its VJP, and each criterion's loss and gradient on
    those logits (JAX's criterion on a model that returns them). Per step
    the loss, nll and token count summed over the microbatches, the
    gradients over the sample size, clipped by their global norm (+1e-6)
    and applied by adam (optax's ``scale_by_adam`` and the lr, in f64).
    Returns the model, its variables, the batch and per smoothing per step
    (metrics, port-keyed weights and batch statistics after it)."""
    # one encoder layer over 4, 3 and 2 encoder frames, 4 output steps
    jmodel, variables, _, frames, target, prev = _models(4, frames=16, tokens=4, encoder_layers=1)
    batch = _train_batch(frames, target, prev)
    criteria = [jax_build_criterion(_train_configs(sm)[0].criterion, _Task()) for sm in SMOOTHINGS]

    def losses_and_grads(params, stats, mb):
        def forward(p):
            logits, updates = jmodel.apply({"params": p, "batch_stats": stats}, mb["src_frames"],
                                           mb["src_lengths"], mb["prev_output_tokens"], train=True,
                                           mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            return logits[0], updates["batch_stats"]

        logits, vjp, new_stats = jax.vjp(forward, params, has_aux=True)
        out = []
        for crit in criteria:
            def loss(lg):  # the criterion on a model that returns lg
                model = type("M", (), {"apply": staticmethod(lambda v, *a, **kw: (lg, None))})
                res = crit(model, {"params": {}}, mb)
                return res[0], res[1:3]

            (lv, (size, logging)), dlogits = jax.value_and_grad(loss, has_aux=True)(logits)
            out.append((lv, size, logging, vjp(dlogits)[0]))
        return out, new_stats

    run = jax_o0.jit(losses_and_grads)
    tmap = jax.tree_util.tree_map
    b1, b2 = 0.9, 0.999
    result = {}
    for which, smoothing in enumerate(SMOOTHINGS):
        params = tmap(lambda x: np.asarray(x, np.float64), variables["params"])
        mu, nu = tmap(np.zeros_like, params), tmap(np.zeros_like, params)
        stats = variables["batch_stats"]
        steps = []
        for t in (1, 2):
            p32 = tmap(lambda x: x.astype(np.float32), params)
            grads, metrics = None, dict.fromkeys(("loss", "nll_loss", "ntokens", "sample_size"), 0.0)
            for i in range(batch["target"].shape[0]):
                out, stats = jax.device_get(run(p32, stats, {k: jnp.asarray(v[i]) for k, v in batch.items()}))
                lv, size, logging, g = out[which]
                grads = g if grads is None else tmap(np.add, grads, g)
                for k, v in (("loss", lv), ("nll_loss", logging["nll_loss"]),
                             ("ntokens", logging["ntokens"]), ("sample_size", size)):
                    metrics[k] += float(v)
            grads = tmap(lambda g: g.astype(np.float64) / metrics["sample_size"], grads)
            metrics["gnorm"] = np.sqrt(sum((g * g).sum() for g in jax.tree_util.tree_leaves(grads)))
            grads = tmap(lambda g: g * min(1.0, CLIP / (metrics["gnorm"] + 1e-6)), grads)
            mu = tmap(lambda m, g: b1 * m + (1 - b1) * g, mu, grads)
            nu = tmap(lambda n, g: b2 * n + (1 - b2) * g * g, nu, grads)
            params = tmap(lambda p, m, n: p - LR * (m / (1 - b1 ** t)) / (np.sqrt(n / (1 - b2 ** t)) + ADAM_EPS),
                          params, mu, nu)
            steps.append((metrics, jax_state_dict({"params": params, "batch_stats": stats})))
        result[smoothing] = steps
    return variables, batch, result


@pytest.mark.parametrize("smoothing", SMOOTHINGS)
def test_train_steps_match_jax(train_run, smoothing):
    """Two train steps of the port on a two-microbatch batch (adam, clip
    0.5) against JAX's criterion, gradients and adam (``train_run``): the
    loss, nll, token count, sample size and gradient norm of each step,
    and every weight and batch statistic after each."""
    variables, batch, want = train_run
    model = load_jax_variables(SpeechLSTMModel(SpeechLSTMConfig(**{**SMALL, "vocab_size": V,
                                                                   "encoder_layers": 1})), variables)
    _, pcfg = _train_configs(smoothing)
    popt, _ = trainer.build_optimizer(pcfg)
    pstate = trainer.create_train_state(model, popt, pcfg)
    pstep = trainer.make_train_step(model, build_criterion(pcfg.criterion, _Task()), popt, pcfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for i, (jm, weights) in enumerate(want[smoothing]):
        pstate, m = pstep(pstate, tbatch, torch.Generator().manual_seed(0))
        for k in ("loss", "nll_loss", "ntokens", "sample_size", "gnorm"):
            np.testing.assert_allclose(m[k].item(), jm[k], rtol=STEP_RTOL, err_msg=f"step {i + 1}: {k}")
        assert m["gnorm"].item() > CLIP  # the clip acts
        got = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        for k, w in weights.items():
            atol = STATS_ATOL if k.endswith(("running_mean", "running_var")) else P_ATOL
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=STEP_RTOL, atol=atol,
                                       err_msg=f"step {i + 1}: {k}")
    assert int(pstate.opt_state.count) == 2
    assert want["uniform"][0][0]["loss"] != want["temporal"][0][0]["loss"]


def test_greedy_decoder_matches_jax(small):
    """JAX's SimpleGreedyDecoder and the port's at max_len 12: each
    utterance's tokens up to its first eos, and its score."""
    jmodel, variables, model, frames, _, _ = small
    batch = {"src_frames": frames, "src_lengths": LENS}
    with jit_o0():
        want = JaxGreedy(jmodel, _Dictionary(), max_len_b=12).decode(variables, batch)
    got = SimpleGreedyDecoder(model, _Dictionary(), max_len_b=12).decode({k: _t(v) for k, v in batch.items()})
    assert any(EOS not in h[0]["tokens"] and len(h[0]["tokens"]) for h in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0]["tokens"], w[0]["tokens"])
        np.testing.assert_allclose(g[0]["score"], w[0]["score"], rtol=SCORE_RTOL)


def _lm(seed, vocab):
    rng = np.random.default_rng(seed)
    kw = dict(vocab_size=vocab, embed_dim=8, hidden_size=12, out_embed_dim=10, num_layers=2, dropout=0.0)
    jlm = JaxLM(JaxLMConfig(**kw))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), jnp.zeros((2, 3), jnp.int32))
    variables = jax.tree_util.tree_map_with_path(_draw(rng, peak=3.0), shapes)
    return jlm, variables, load_jax_variables(LSTMLanguageModel(LSTMLMConfig(**kw)).eval(), variables)


@pytest.mark.parametrize("fused", [False, True], ids=["beam", "beam_lm_v5003"])
def test_beam_search_matches_jax(small, fused):
    """JAX's BeamSearchDecoder and the port's: K = 4 at V = 40 with
    len_penalty 0.5, min_len 2 and a prefix on two utterances; fused with
    an LSTM LM at lm_weight 0.5, K = 5 at V = 5,003 with eos_factor 1.2 and
    len_penalty 1. Every one of the K hypotheses of each utterance is the
    same token sequence, its score within SCORE_RTOL."""
    vocab = 5003 if fused else V
    jmodel, variables, model, frames, _, _ = _models(3, vocab=vocab, peak=3.0) if fused else small
    batch = {"src_frames": frames, "src_lengths": LENS}
    if fused:
        jlm, lm_vars, lm = _lm(12, vocab)
        opts, jx, px, prefix = dict(beam_size=5, max_len_b=9, eos_factor=1.2), dict(lm=jlm, lm_weight=0.5), \
            dict(lm=lm, lm_weight=0.5), None
    else:
        opts, jx, px = dict(beam_size=4, max_len_b=10, len_penalty=0.5, min_len=2), {}, {}
        prefix = np.array([[5, 6, PAD], [PAD, PAD, PAD], [7, 8, 9]], np.int32)
    jdec = JaxBeamSearch(jmodel, _Dictionary(), **opts, **jx)
    if fused:
        jdec.lm_variables = lm_vars
    with jit_o0():
        want = jdec.decode(variables, batch, prefix_tokens=prefix)
    got = BeamSearchDecoder(model, _Dictionary(), **opts, **px).decode(
        {k: _t(v) for k, v in batch.items()}, prefix_tokens=None if prefix is None else _t(prefix))
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == opts["beam_size"]
        for k, (gh, wh) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gh["tokens"], wh["tokens"], err_msg=f"utterance {b}, hyp {k}")
            np.testing.assert_allclose(gh["score"], wh["score"], rtol=SCORE_RTOL)
    if prefix is not None:
        assert all(list(h["tokens"][:2]) == [5, 6] for h in got[0])
    assert len({tuple(h["tokens"]) for h in got[0]}) == opts["beam_size"]


def _flax_variables(model):
    """The port model's weights as a flax variable tree (``bridge.flax_paths``
    and the flax layouts), numpy f32."""
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


def test_bf16_paths_match_jax_at_librispeech_width():
    """The bf16 paths of both at speech_conv_lstm_librispeech's widths (the
    4-layer frontend on 80-dim features, a bi-LSTM of 1024 cut to one
    layer, two decoder layers of 1024, attention 512, output embedding
    3,072, V = 5,003), B = 2, from the port's seeded init at LeCun's scale
    (its output layer x6, so that greedy choices are not near-ties): variables and frames
    cast to bf16 as the decode CLIs cast them. The encoder output and the
    teacher-forced logits within BF16_ENC_ATOL and BF16_LOGIT_ATOL; the
    port's greedy tokens (its decoder, its carry in bf16) are the argmax
    chain of JAX's bf16 logits teacher-forced on them, up to near-ties. JAX's own greedy
    decoder does not run on bf16 variables: it starts its carry in f32 and
    its scan refuses the bf16 context that the first step returns."""
    kw = dict(feat_dim=80, vocab_size=5003, encoder_hidden_size=1024, encoder_layers=1,
              decoder_embed_dim=48, decoder_hidden_size=1024, decoder_out_embed_dim=3072,
              decoder_layers=2, attention_dim=512, dropout=0.0)
    torch.manual_seed(13)
    model = SpeechLSTMModel(SpeechLSTMConfig(**kw)).eval()
    with torch.no_grad():  # torch's uniform init at LeCun's scale, 1/sqrt(fan-in)
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.ndim > 1 and "embed" not in name:
                p.mul_(3 ** 0.5 * (6.0 if "fc_out" in name else 1.0))
    variables = _flax_variables(model)
    model.to(torch.bfloat16)
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((2, 32, 80)).astype(np.float32)
    lens = np.array([32, 21], np.int32)
    tframes = _t(frames).to(torch.bfloat16)
    with torch.no_grad():
        greedy = SimpleGreedyDecoder(model, _Dictionary(), max_len_b=GREEDY_STEPS).search(tframes, _t(lens))[0]
        prev = torch.cat([torch.full((2, 1), EOS), greedy[:, :-1].long()], 1)
        logits, enc = model(tframes, _t(lens), prev)
    jmodel = JaxModel(JaxConfigLSTM(**kw))
    jvars = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), variables)  # numpy casts, no compile
    want_logits, want_enc = jax.device_get(jax_o0.jit(
        lambda v, x, p: (lambda o: (o[0], o[1].encoder_out))(jmodel.apply(v, x, lens, p))
    )(jvars, jnp.asarray(frames).astype(jnp.bfloat16), prev.numpy().astype(np.int32)))
    valid = enc.encoder_padding_mask.numpy()[..., None]
    enc_err = np.abs(enc.encoder_out.float().numpy() - want_enc.astype(np.float32)) * valid
    logit_err = np.abs(logits.float().numpy() - want_logits.astype(np.float32))
    assert enc_err.max() < BF16_ENC_ATOL and logit_err.max() < BF16_LOGIT_ATOL, (enc_err.max(), logit_err.max())
    want = want_logits.astype(np.float32)
    for b in range(2):  # up to the row's first eos
        toks = greedy[b].numpy()
        end = next((i + 1 for i, t in enumerate(toks) if t == EOS), GREEDY_STEPS)
        picked = want[b, np.arange(end), toks[:end]]
        assert (picked >= want[b, :end].max(-1) - BF16_LOGIT_ATOL).all(), (b, toks, want[b].argmax(-1))


@pytest.mark.parametrize("arch", ["speech_conv_lstm_wsj", "speech_conv_lstm_librispeech", "speech_conv_lstm_swbd"])
def test_architectures_resolve_and_build_as_jax_does(tmp_path, monkeypatch, arch):
    """Each architecture through both packages' tasks: the same model
    config field by field, the port model built from it (on the meta
    device), and a ``model_cfg.json`` the port's train CLI writes resolved
    alike by both packages' ``apply_saved_model_cfg``. The parameter tree
    a config gives is held leaf for leaf and shape for shape by the small
    models' ``load_jax_variables``."""
    from espresso_tpu import config as jax_config
    from espresso_tpu.tasks import setup_task as jax_setup_task
    from espresso_tpu_torch import config as port_config
    from espresso_tpu_torch.cli.train import write_model_cfg
    from espresso_tpu_torch.tasks import setup_task as port_setup_task

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    d = str(tmp_path)
    with open(f"{d}/dict.txt", "w") as f:
        f.writelines(f"u{i} 1\n" for i in range(20))
    argv = [f"dataset.data={d}", f"model.name={arch}", f"checkpoint.save_dir={d}/ckpt"]
    jt = jax_setup_task(jax_config.parse_config(argv))
    pt = port_setup_task(port_config.parse_config(argv))
    jt.build_model()
    _, got = pt.build_model_config()
    assert port_config.config_to_dict(got) == jax_config.config_to_dict(jt.model_cfg)
    assert got.vocab_size == len(pt.dictionary) == 23
    with torch.device("meta"):
        model = SpeechLSTMModel(got)
    write_model_cfg(f"{d}/ckpt", model, pt.cfg, got)
    dec = [f"dataset.data={d}", f"checkpoint.save_dir={d}/ckpt", "model.attention_dim=64"]
    jcfg = jax_config.apply_saved_model_cfg(jax_config.parse_config(dec), dec)
    pcfg = port_config.apply_saved_model_cfg(port_config.parse_config(dec), dec)
    assert pcfg.model == jcfg.model and pcfg.model["attention_dim"] == 64
    assert pcfg.criterion.name == jcfg.criterion.name == "label_smoothed_cross_entropy_v2"


def test_refused_options_raise(small, tmp_path):
    """What the port does not carry raises NotImplementedError naming its
    ROADMAP item: the beam search's sampling, diverse groups, n-gram
    blocking, lexical constraints and ensembles (queue A item 1); the
    transformer LM's adapter and the LM's greedy decode (item 2);
    ``generation.print_alignment`` for this model (item 3, tools/plot). The
    CTC task's decoders, refused here before they were ported, build."""
    from espresso_tpu_torch.cli import speech_recognize
    from espresso_tpu_torch.config import parse_config
    from espresso_tpu_torch.tasks import setup_task
    from utils import make_corpus

    model = small[2]
    for kw in (dict(sampling=True), dict(diverse_beam_groups=2), dict(no_repeat_ngram_size=3)):
        with pytest.raises(NotImplementedError, match="queue A item 1"):
            BeamSearchDecoder(model, _Dictionary(), **kw)
    with pytest.raises(NotImplementedError, match="queue A item 1"):
        BeamSearchDecoder([model, model], _Dictionary())
    batch = {"src_frames": torch.zeros(1, 24, F), "src_lengths": torch.tensor([24])}
    with pytest.raises(NotImplementedError, match="queue A item 1"):
        BeamSearchDecoder(model, _Dictionary()).decode(batch, constraints=torch.ones(1, 1, 2))
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        make_adapter(type("TransformerLanguageModel", (), {})())
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        SimpleGreedyDecoder(LSTMLanguageModel(LSTMLMConfig(vocab_size=V)), _Dictionary())
    d = str(tmp_path)
    make_corpus(d, "test", num_utts=2, feat_dim=F, seed=0)
    ctc = setup_task(parse_config([f"dataset.data={d}", "criterion.name=ctc_loss"]))
    assert [type(build(model)).__name__ for build in (ctc.build_valid_decoder, ctc.build_generator)] == \
        ["CTCGreedyDecoder", "CTCGreedyDecoder"]  # the default beam of 1
    argv = [f"dataset.data={d}", "dataset.feat_dim=12", f"checkpoint.save_dir={d}/none",
            "model.name=speech_conv_lstm_wsj", "model.encoder_hidden_size=8", "model.decoder_hidden_size=8",
            "model.attention_dim=8", "generation.print_alignment=true", "common.dtype=float32"]
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        speech_recognize.main(argv, device="cpu")


def test_chip_smoke_recipe_is_the_yaml():
    """chip_smoke.LSTM_RECIPE (written out for a card machine without
    PyYAML) is examples/asr_librispeech/lstm_librispeech.yaml."""
    import os
    import sys

    from espresso_tpu_torch import config as port_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    yaml_cfg = port_config.parse_config(["--config", f"{root}/examples/asr_librispeech/lstm_librispeech.yaml"])
    assert port_config.config_to_dict(port_config.load_config_dict(chip_smoke.LSTM_RECIPE)) == \
        port_config.config_to_dict(yaml_cfg)


def test_task_batches_for_the_cross_entropy_criteria_match_jax(tmp_path, monkeypatch):
    """For label_smoothed_cross_entropy_v2 both tasks load the dictionary
    without a blank (``enable_bos`` off) and collate autoregressively:
    eos-led ``prev_output_tokens``, eos-ended targets, the same arrays."""
    from espresso_tpu import config as jax_config
    from espresso_tpu.tasks import setup_task as jax_setup_task
    from espresso_tpu_torch import config as port_config
    from espresso_tpu_torch.tasks import setup_task as port_setup_task
    from utils import make_corpus

    monkeypatch.setenv("ESPRESSO_COMPILE_CACHE", "0")  # JAX's parse_config would turn it on
    d = str(tmp_path)
    make_corpus(d, "train", num_utts=6, feat_dim=F, seed=2)
    argv = [f"dataset.data={d}", "criterion.name=label_smoothed_cross_entropy_v2", f"dataset.feat_dim={F}"]
    jt, pt = jax_setup_task(jax_config.parse_config(argv)), port_setup_task(port_config.parse_config(argv))
    assert len(jt.dictionary) == len(pt.dictionary) and pt.dictionary.bos_index is None
    assert jt.autoregressive and pt.autoregressive
    jds, pds = jt.load_dataset("train"), pt.load_dataset("train")
    kw = dict(max_tokens=200, max_sentences=None, num_buckets=2, shuffle=False)
    for js, ps in zip(jds.make_batch_specs(**kw), pds.make_batch_specs(**kw)):
        jb, pb = jds.collate(js), pds.collate(ps)
        for k in ("src_frames", "src_lengths", "prev_output_tokens", "target", "tgt_lengths", "weight"):
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        rows = pb["tgt_lengths"] > 0
        assert (pb["prev_output_tokens"][rows, 0] == pt.dictionary.eos()).all()
        assert (pb["target"][rows, pb["tgt_lengths"][rows] - 1] == pt.dictionary.eos()).all()
