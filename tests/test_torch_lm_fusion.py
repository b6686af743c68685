"""LSTM-LM shallow fusion in the port's AES beam decoder, against JAX.

The port's LSTM LM (``models/lstm_lm.py``) against JAX's
``LSTMLanguageModel``; the gate padding of a cell stack
(``ops/decode_kernels.py::prep_lstm_kernel_inputs``) through the plain
version of ``lstm_step_reorder``; and the LM-fused beam decode against JAX's
``TransducerBeamSearchDecoder`` with the same LM. The transducer is the
beam tests' small Conformer-Transducer (1 layer, D=64, joint 64, V=32, joint
peaked x6) with a prediction net whose embedding (32) is narrower than its
hidden width (64), so every decode here also runs the gate-padded
prediction net. The LM: V_lm = 31 (the blank-less vocab), embed 24, hidden
40, out_embed 32 (so ``additional_fc``), 2 layers. Variables are drawn from
numpy on the shapes of JAX's init (``jax.eval_shape``: no init compile) and
loaded into the port with ``bridge.load_jax_variables``. fp32 on the CPU,
torch on one thread, where the decoder's kernel wrappers run their plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espresso_tpu.decode.transducer_beam import (
    TransducerBeamSearchDecoder as JaxBeamDecoder,
)
from espresso_tpu.models.lstm_lm import LSTMLanguageModel as JaxLSTMLM
from espresso_tpu.models.lstm_lm import LSTMLMConfig as JaxLMConfig
from espresso_tpu.models.transducer import TransducerModel as JaxTransducerModel
from espresso_tpu_torch.bridge import load_jax_variables
from espresso_tpu_torch.decode import transducer_beam
from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
from espresso_tpu_torch.models.lstm_lm import ARCHITECTURES, LSTMLanguageModel, LSTMLMConfig
from espresso_tpu_torch.models.transducer import TransducerModel
from espresso_tpu_torch.ops import decode_kernels as dk
from test_torch_transducer_beam import BEAM, LENS, TOL, B, F, T, V, _assert_same, _configs, _dictionaries

PRED_E = 32  # the prediction net's embedding width, under its hidden width 64
LM = dict(vocab_size=V - 1, embed_dim=24, hidden_size=40, out_embed_dim=32, num_layers=2)
LM_WEIGHT = 0.5


def _draw(rng, path, shape):
    """An init-like value for a flax leaf: kernels at 1/sqrt(fan-in), norms'
    scales and running variances near 1, the rest small."""
    name = path[-1].key
    if name == "kernel":
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ("scale", "var"):
        return 1.0 + 0.2 * rng.random(shape)
    if name == "embedding":
        return rng.standard_normal(shape)
    return 0.1 * rng.standard_normal(shape)


def _variables(module, rng, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_draw(rng, p, s.shape), np.float32), shapes
    )


def _lm_variables(rng, vocab_size, embed_dim, hidden_size, out_embed_dim, num_layers, share=False):
    cfg = JaxLMConfig(
        vocab_size=vocab_size, embed_dim=embed_dim, hidden_size=hidden_size,
        out_embed_dim=out_embed_dim, num_layers=num_layers, dropout=0.0, share_embed=share,
    )
    jlm = JaxLSTMLM(cfg)
    variables = _variables(jlm, rng, jnp.zeros((2, 3), jnp.int32))
    port = LSTMLanguageModel(LSTMLMConfig(**{**cfg.__dict__})).eval()
    return jlm, variables, load_jax_variables(port, variables)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(one_thread):
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((B, T, F)).astype(np.float32)
    jcfg, pcfg = _configs()
    jcfg.pred_embed_dim = pcfg.pred_embed_dim = PRED_E
    jmodel = JaxTransducerModel(jcfg)
    variables = _variables(
        jmodel, rng, jnp.asarray(frames), jnp.asarray(LENS), jnp.zeros((B, 2), jnp.int32)
    )
    for leaf in ("kernel", "bias"):
        variables["params"]["joint"]["fc_out"][leaf] *= 6.0
    model = load_jax_variables(TransducerModel(pcfg).eval(), variables)
    jlm, lm_vars, lm = _lm_variables(rng, **LM)
    for leaf in ("kernel", "bias"):  # a peaked LM, so that its terms weigh
        lm_vars["params"]["decoder"]["fc_out"][leaf] *= 3.0
    load_jax_variables(lm, lm_vars)
    return dict(jmodel=jmodel, variables=variables, model=model, frames=frames, jlm=jlm,
                lm_vars=lm_vars, lm=lm)


@pytest.mark.parametrize("share", [False, True])
def test_lstm_lm_matches_jax(one_thread, share):
    """The sequence forward and two decode steps, E != H != out_embed (so
    ``additional_fc``), with and without the shared output embedding."""
    rng = np.random.default_rng(3 + share)
    dims = dict(vocab_size=29, embed_dim=24, hidden_size=40, out_embed_dim=24 if share else 32)
    jlm, variables, lm = _lm_variables(rng, num_layers=2, share=share, **dims)
    params = variables["params"]["decoder"]
    assert "additional_fc" in params and ("fc_out" in params) != share
    toks = rng.integers(0, 29, (3, 7)).astype(np.int32)
    want = np.asarray(jlm.apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        got = lm(torch.from_numpy(toks).long()).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        carry_j = jlm.apply(variables, 3, method="init_carry")
        carry_t = lm.init_carry(3)
        step = jax.jit(lambda tok, carry: jlm.apply(variables, tok, carry, method="decode_step"))
        for u in range(2):
            lj, carry_j = step(jnp.asarray(toks[:, u]), carry_j)
            lt, carry_t = lm.decode_step(torch.from_numpy(toks[:, u]).long(), carry_t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(lt.numpy(), want[:, u], atol=1e-5, rtol=1e-5)
    assert set(ARCHITECTURES) == {"lstm_lm_wsj", "lstm_wordlm_wsj", "lstm_lm_librispeech",
                                  "lstm_lm_swbd"}


def test_lstm_padding_is_exact_through_the_plain_step():
    """A stack with E = 24 < H = 40 gate-padded to Hp = 64: the plain
    version's bf16 step on the padded stack gives bit for bit the unpadded
    stack's h and c (the same product sums and bf16 gate chains), and the
    padded channels stay 0, dead rows and all."""
    g = torch.Generator().manual_seed(0)
    V_, E, H_, L, B_, K = 31, 24, 40, 2, 3, 4
    bf, BK = torch.bfloat16, B_ * K
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.4).to(bf)
    embed = mk(V_, E)
    w_ih = [mk(E, 4 * H_)] + [mk(H_, 4 * H_) for _ in range(L - 1)]
    w_hh = [mk(H_, 4 * H_) for _ in range(L)]
    b_ih = [mk(4 * H_).float() for _ in range(L)]
    kw = dk.prep_lstm_kernel_inputs(embed, w_ih, b_ih, w_hh)
    Hp = kw["Hp"]
    assert (Hp, kw["H"]) == (64, H_) and kw["embed"].shape == (V_, Hp)
    assert kw["w_ih"].shape == kw["w_hh"].shape == (L, Hp, 4 * Hp) and kw["b_ih"].shape == (L, 4 * Hp)
    h, c = mk(L, BK, H_), mk(L, BK, H_)
    tok = torch.randint(0, V_, (BK,), generator=g)
    src = torch.randint(0, BK, (BK,), generator=g)
    live = torch.rand(BK, generator=g) < 0.7
    pad = lambda x: torch.nn.functional.pad(x, (0, Hp - H_))
    S = dk.pack_lstm_state(pad(h), pad(c))
    for _ in range(2):  # a second step starts from the padded output
        S = dk.lstm_step_reorder(
            kw["embed"][tok], S, src, live, kw["w_ih"], kw["b_ih"], kw["w_hh"], B=B_, K=K
        )
        x, hs, cs = embed[tok], [], []
        for layer in range(L):
            hg, cg = h[layer][src], c[layer][src]
            pre = (x.float() @ w_ih[layer].float() + hg.float() @ w_hh[layer].float()) + b_ih[layer]
            hn, cn = dk._bf16_gates(pre.bfloat16(), cg)
            hs.append(torch.where(live[:, None], hn, hg))
            cs.append(torch.where(live[:, None], cn, cg))
            x = hn
        h, c = torch.stack(hs), torch.stack(cs)
        ho, co = dk.unpack_lstm_state(S, L)
        assert torch.equal(ho[..., :H_], h) and torch.equal(co[..., :H_], c)
        assert not ho[..., H_:].any() and not co[..., H_:].any()
    # no padding (and no copy of the table) when E = H is a multiple of 64
    same = dk.prep_lstm_kernel_inputs(mk(V_, 64), [mk(64, 256)], [torch.zeros(256)], [mk(64, 256)])
    assert same["Hp"] == 64 and same["w_ih"].shape == (1, 64, 256)


def _decoder(s, **kw):
    return TransducerBeamSearchDecoder(s["model"], _dictionaries()[1], **BEAM, **kw)


def _bf16_lm_step(decoder):
    """The port's LSTM step with bf16 copies of the LM's operands, back in
    fp32: what JAX's LM kernel does to fp32 operands in interpret mode (its
    prediction net, E != H, runs JAX's fp32 step, as the port's does)."""
    plain = transducer_beam.lstm_step_reorder

    def step(x, S, src, live, w_ih, b_ih, w_hh, B, K):
        if w_ih is not decoder.lm_w["w_ih"]:
            return plain(x, S, src, live, w_ih, b_ih, w_hh, B=B, K=K)
        bf = torch.bfloat16
        return plain(x.to(bf), S.to(bf), src, live, w_ih.to(bf), b_ih, w_hh.to(bf), B=B, K=K).float()

    return step


@pytest.mark.parametrize("fused_kernel,prefix_alpha,n_exp", [("off", 1, 2), ("interpret", 2, 1)])
def test_lm_fused_beam_decode_matches_jax(setup, monkeypatch, fused_kernel, prefix_alpha, n_exp):
    """The LM-fused decode at lm_weight 0.5: at prefix_alpha 1 against
    JAX's jnp structure, and at prefix_alpha 2 (the depth-2 merge through
    the ring of cached LM rows) against JAX's Pallas kernels in interpret
    mode (the joint's label bias and factor, the LM's kernel step in bf16):
    hypotheses equal, scores within the beam tests' tolerance. Each case
    compiles a JAX decoder (~10-15 s on one core), so prefix_alpha 2 runs
    only through the kernels' structure, the one the port follows."""
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    s = setup
    kw = dict(prefix_alpha=prefix_alpha, max_num_expansions_per_step=n_exp, lm_weight=LM_WEIGHT)
    batch = {"src_frames": s["frames"], "src_lengths": LENS}
    want = JaxBeamDecoder(
        s["jmodel"], _dictionaries()[0], fused_kernel=fused_kernel, lm=s["jlm"],
        lm_variables=s["lm_vars"], **BEAM, **kw,
    ).decode(s["variables"], batch)
    decoder = _decoder(s, lm=s["lm"], **kw)
    if fused_kernel == "interpret":
        monkeypatch.setattr(transducer_beam, "lstm_step_reorder", _bf16_lm_step(decoder))
    got = decoder.decode(batch)
    _assert_same(got, want, TOL)
    # the LM moved the search: without it the best hypotheses differ
    plain = _decoder(s, prefix_alpha=prefix_alpha, max_num_expansions_per_step=n_exp).decode(batch)
    assert any(abs(g[0]["score"] - p[0]["score"]) > 10 * TOL for g, p in zip(got, plain))


def test_lm_weight_zero_is_the_no_lm_decoder(setup):
    batch = {"src_frames": setup["frames"], "src_lengths": LENS}
    got = _decoder(setup, lm=setup["lm"], lm_weight=0.0).decode(batch)
    want = _decoder(setup).decode(batch)
    for g, w in zip(got, want):
        assert [(h["tokens"].tolist(), h["score"]) for h in g] == [
            (h["tokens"].tolist(), h["score"]) for h in w
        ]
