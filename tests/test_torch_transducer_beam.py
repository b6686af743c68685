"""Parity of the port's AES beam decoder against JAX and a brute-force oracle.

A small Conformer-Transducer (1 conformer layer, D=64, 2 heads, ffn 128,
conv kernel 15, pred 2x64, joint 64, V=32) is initialised in JAX, its
variables perturbed from a numpy seed, its joint output peaked (x6, as the
greedy test does, so that hypotheses are not empty and near-ties are rare),
and loaded into the port through ``bridge.py``. Everything runs in fp32 on
the CPU, where the decoder's kernel wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_o0
from jax_o0 import jit_o0
from espresso_tpu.data.dictionary import AsrDictionary as JaxDictionary
from espresso_tpu.decode.transducer_beam import INV31 as JAX_INV31
from espresso_tpu.decode.transducer_beam import (
    TransducerBeamSearchDecoder as JaxBeamDecoder,
)
from espresso_tpu.models.speech_transformer import (
    SpeechTransformerConfig as JaxEncoderConfig,
)
from espresso_tpu.models.transducer import (
    TransducerConfig as JaxTransducerConfig,
    TransducerModel as JaxTransducerModel,
)
from espresso_tpu_torch.bridge import load_jax_variables
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.decode import transducer_beam
from espresso_tpu_torch.decode.transducer_beam import (
    INV31,
    TransducerBeamSearchDecoder,
    hash_pop,
    hash_push,
)
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import decode_kernels as dk
from test_transducer_beam_oracle import oracle_aes
from test_torch_transducer import _perturb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, T, F = 3, 44, 80  # 10 encoder frames
LENS = np.array([44, 33, 20], np.int32)
D, FFN, H, CK, PRED, JOINT, V = 64, 128, 2, 15, 64, 64, 32
BEAM = dict(beam_size=4, expansion_beta=2, expansion_gamma=4.0, max_out_factor=0.35)
TOL = 1e-4  # fp32 on the CPU, summed in another order by each framework


def _configs():
    enc = JaxEncoderConfig(
        feat_dim=F, vocab_size=V, encoder_layer_type="conformer", encoder_pos_type="relative",
        encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=1, encoder_heads=H,
        depthwise_conv_kernel_size=CK, dropout=0.0,
    )
    jcfg = JaxTransducerConfig(
        feat_dim=F, vocab_size=V, encoder=enc, pred_embed_dim=PRED, pred_hidden_size=PRED,
        pred_layers=2, pred_dropout=0.0, joint_dim=JOINT,
    )
    pcfg = TransducerConfig(
        feat_dim=F, vocab_size=V,
        encoder=SpeechTransformerConfig(
            encoder_layer_type="conformer", encoder_pos_type="relative",
            encoder_embed_dim=D, encoder_ffn_dim=FFN, encoder_layers=1, encoder_heads=H,
            depthwise_conv_kernel_size=CK,
        ),
        pred_embed_dim=PRED, pred_hidden_size=PRED, pred_layers=2, joint_dim=JOINT,
    )
    return jcfg, pcfg


def _dictionaries():
    jd, pd = JaxDictionary(enable_bos=True), AsrDictionary(enable_bos=True)
    for i in range(V - len(pd)):
        jd.add_symbol(f"u{i}")
        pd.add_symbol(f"u{i}")
    return jd, pd


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, T, F)).astype(np.float32)
    jcfg, pcfg = _configs()
    jmodel = JaxTransducerModel(jcfg)
    variables = jax_o0.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(frames), jnp.asarray(LENS), jnp.zeros((B, 2), jnp.int32)
    )
    variables = _perturb(jax.device_get(variables), rng)
    for leaf in ("kernel", "bias"):
        variables["params"]["joint"]["fc_out"][leaf] = variables["params"]["joint"]["fc_out"][leaf] * 6.0
    model = load_jax_variables(TransducerModel(pcfg).eval(), variables)
    return jmodel, variables, model, frames


def _assert_same(got, want, tol):
    emitted = sum(len(h["tokens"]) for hyps in got for h in hyps)
    assert emitted >= 5, emitted
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (b, len(g), len(w))
        for hg, hw in zip(g, w):
            np.testing.assert_array_equal(hg["tokens"], hw["tokens"])
            assert abs(hg["score"] - hw["score"]) <= tol, (b, hg["score"], hw["score"])


def _decode_both(setup, monkeypatch, fused_kernel="off", **kw):
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jmodel, variables, model, frames = setup
    jd, pd = _dictionaries()
    batch = {"src_frames": frames, "src_lengths": LENS}
    with jit_o0():
        want = JaxBeamDecoder(jmodel, jd, fused_kernel=fused_kernel, **BEAM, **kw).decode(variables, batch)
    got = TransducerBeamSearchDecoder(model, pd, **BEAM, **kw).decode(batch)
    return got, want


@pytest.mark.parametrize("n_exp", [1, 2])
@pytest.mark.parametrize("prefix_alpha", [0, 1, 2])
def test_beam_decode_matches_jax(setup, monkeypatch, n_exp, prefix_alpha):
    got, want = _decode_both(
        setup, monkeypatch, max_num_expansions_per_step=n_exp, prefix_alpha=prefix_alpha
    )
    _assert_same(got, want, TOL)


def test_beam_decode_matches_jax_eos_folded(setup, monkeypatch):
    got, want = _decode_both(setup, monkeypatch, model_predicts_eos=True)
    _assert_same(got, want, TOL)


def _bf16_pred_step(x, S, src, live, w_ih, b_ih, w_hh, B, K):
    """The port's prediction-net step on bf16 copies of its operands, back
    in fp32: what the JAX pred-net kernel does to fp32 operands."""
    bf = torch.bfloat16
    return dk.lstm_step_reorder(
        x.to(bf), S.to(bf), src, live, w_ih.to(bf), b_ih, w_hh.to(bf), B=B, K=K
    ).float()


def test_beam_decode_matches_jax_interpreted_kernels(setup, monkeypatch):
    """The JAX decoder through its four Pallas kernels in interpret mode.
    Its prediction-net kernel casts fp32 operands to bf16 and rounds its
    gate chains to bf16 (interpret mode skips its dtype gate,
    decode_kernels.py:446-452), so the port's step gets bf16 copies here
    and its plain version rounds at the same points. The rest is fp32 on
    both sides, so the fp32 tolerance holds."""
    monkeypatch.setattr(transducer_beam, "lstm_step_reorder", _bf16_pred_step)
    got, want = _decode_both(setup, monkeypatch, fused_kernel="interpret")
    _assert_same(got, want, TOL)


class _PortAsOracleModel:
    """The port model behind the oracle's numpy interface
    (tests/test_transducer_beam_oracle.py:104)."""

    def __init__(self, model):
        self.model, self.V = model, model.cfg.vocab_size

    def np_pred_step(self, token, state):
        h, c = (torch.from_numpy(np.asarray(x))[:, None] for x in state)
        with torch.no_grad():
            feat, (h2, c2) = self.model.pred_step(torch.tensor([token]), (h, c))
        return feat[0].numpy(), (h2[:, 0].numpy(), c2[:, 0].numpy())

    def np_logits(self, enc_t, feat):
        with torch.no_grad():
            return self.model.joint_step_precomputed(
                torch.from_numpy(enc_t)[None], torch.from_numpy(feat)[None]
            )[0].numpy()


@pytest.mark.parametrize("n_exp,prefix_alpha", [(1, 1), (2, 0), (2, 2)])
def test_beam_decode_matches_bruteforce_oracle(setup, n_exp, prefix_alpha):
    _, _, model, frames = setup
    _, pd = _dictionaries()
    beam = dict(BEAM, expansion_gamma=6.0)
    got = TransducerBeamSearchDecoder(
        model, pd, max_num_expansions_per_step=n_exp, prefix_alpha=prefix_alpha, **beam
    ).decode({"src_frames": frames, "src_lengths": LENS})
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames), torch.from_numpy(LENS))
        enc_proj = model.joint_enc_proj(enc.encoder_out).numpy()
    zeros = np.zeros((2, PRED), np.float32)
    oracle = _PortAsOracleModel(model)
    for b in range(B):
        ref = oracle_aes(
            oracle, enc_proj[b], int(enc.src_lengths[b]), beam["beam_size"],
            beam["expansion_beta"], beam["expansion_gamma"], n_exp,
            prefix_alpha=prefix_alpha, init_state=(zeros, zeros),
        )
        assert len(got[b]) == len(ref), (b, len(got[b]), len(ref))
        for g, r in zip(got[b], ref):
            assert tuple(g["tokens"]) == r["seq"], (b, tuple(g["tokens"]), r["seq"])
            assert abs(g["score"] - r["score"]) <= TOL, (b, g["score"], r["score"])


def test_rolling_hash_wraps_like_jax_int32():
    """A 40-token sequence overflows int32 many times over: the port's
    int64-then-wrap hash equals JAX's int32 arithmetic at every step, and
    popping the tokens back returns to 0."""
    assert INV31 == int(JAX_INV31)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 5000, size=(40, 6)).astype(np.int32)
    hj = jnp.zeros(6, jnp.int32)
    ht = torch.zeros(6, dtype=torch.int32)
    for tok in toks:
        hj = hj * jnp.int32(31) + (jnp.asarray(tok) + 1)
        ht = hash_push(ht, torch.from_numpy(tok))
        assert ht.dtype == torch.int32
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert np.abs(ht.numpy().astype(np.int64)).max() > 2**20
    for tok in toks[::-1]:
        hj = (hj - (jnp.asarray(tok) + 1)) * JAX_INV31
        ht = hash_pop(ht, torch.from_numpy(tok))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ht.numpy(), 0)


def test_unported_options_raise(setup):
    """``max_num_expansions_per_step=0`` and an LM without an adapter raise;
    LM fusion (tests/test_torch_lm_fusion.py) and a prediction net whose
    embedding width is not its hidden width (gate-padded) are taken."""
    _, _, model, _ = setup
    _, pd = _dictionaries()
    with pytest.raises(TypeError, match="adapter"):
        TransducerBeamSearchDecoder(model, pd, lm=object(), lm_weight=0.5)
    with pytest.raises(NotImplementedError, match="expansions"):
        TransducerBeamSearchDecoder(model, pd, max_num_expansions_per_step=0)
    _, pcfg = _configs()
    pcfg.pred_embed_dim = 32
    pw = TransducerBeamSearchDecoder(TransducerModel(pcfg), pd).pred_w
    assert (pw["H"], pw["Hp"]) == (PRED, PRED) and pw["embed"].shape == (V, PRED)
