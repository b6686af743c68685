"""The Conformer-Transducer's bf16 path against JAX's, on the CPU.

At the flagship's width (d 512, ffn 2048, 8 heads, conv kernel 31, a 2 x
512 prediction net, joint 512, V = 1,024) cut to 2 conformer layers, from
the port's seeded init (its joint output x4), carried into JAX through
``bridge.flax_paths``. Both sides in
bf16 as their decode CLIs and train steps run it (the port's kernel
wrappers run their plain versions here): the encoder output, one train
step's loss and gradient norm (bf16 compute copies of fp32 masters), and
the AES beam decode of 8 short utterances. Torch runs on one thread.
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
from espresso_tpu.data.dictionary import AsrDictionary as JaxDictionary
from espresso_tpu.decode.transducer_beam import TransducerBeamSearchDecoder as JaxBeamDecoder
from espresso_tpu.models.speech_transformer import SpeechTransformerConfig as JaxEncoderConfig
from espresso_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from espresso_tpu.models.transducer import TransducerModel as JaxTransducerModel
from espresso_tpu.train.trainer import cast_floats
from espresso_tpu_torch.bridge import flax_paths, to_flax_layout
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import build_criterion
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.train import trainer

F, V, LAYERS = 80, 1024, 2
B, T = 8, 48  # 12 encoder frames at most
LENS = np.array([48, 44, 40, 36, 32, 28, 24, 20], np.int32)
U = 6
BEAM = dict(beam_size=4, expansion_beta=2, expansion_gamma=2.3, max_out_factor=0.35)
# bf16 on both sides, rounded at other points (XLA fuses elementwise chains
# in f32, torch rounds after each op): the encoder output within BF16_ULPS
# ulps of its largest value (one draw: 4 ulps, 0.0625 at |x| <= 3.3, after
# two conformer layers' macaron FFNs, conv modules and batch norms); the
# train step's loss and gradient norm within STEP_RTOL, relative (one draw:
# 1.7e-4 and 1.1e-4; a fault moves either by O(1)). The beam: this random
# model's n-best lists are near-ties (neighbouring scores 0.03-0.4 apart at
# scores of 36-85), and bf16 rounding moves a score by up to ~0.4 (either
# side against its own fp32 decode), so the two top hypotheses may be other
# token sequences of nearly the same score: each utterance's best score
# within SCORE_RTOL, relative (one draw: 0.6 % at most, the top hypotheses
# equal on 4 of 8)
BF16_ULPS, STEP_RTOL, SCORE_RTOL = 8, 0.01, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    enc = dict(feat_dim=F, vocab_size=V, encoder_layer_type="conformer", encoder_pos_type="relative",
               encoder_embed_dim=512, encoder_ffn_dim=2048, encoder_layers=LAYERS, encoder_heads=8,
               depthwise_conv_kernel_size=31, dropout=0.0)
    rest = dict(feat_dim=F, vocab_size=V, pred_embed_dim=512, pred_hidden_size=512, pred_layers=2,
                pred_dropout=0.0, joint_dim=512)
    return (JaxTransducerConfig(encoder=JaxEncoderConfig(**enc), **rest),
            TransducerConfig(encoder=SpeechTransformerConfig(**enc), **rest))


def _flax_variables(model):
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
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


class _Task:
    def __init__(self, d):
        self.dictionary = d


def _dictionaries():
    jd, pd = JaxDictionary(enable_bos=True), AsrDictionary(enable_bos=True)
    for i in range(V - len(pd)):
        jd.add_symbol(f"u{i}")
        pd.add_symbol(f"u{i}")
    return jd, pd


@pytest.fixture(scope="module")
def setup():
    """The fp32 port model (seeded, joint output x4), its flax variables,
    frames, targets and the dictionaries."""
    jcfg, pcfg = _configs()
    torch.manual_seed(21)
    model = TransducerModel(pcfg)
    with torch.no_grad():
        model.joint.fc_out.weight.mul_(4.0)
    variables = _flax_variables(model)
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((B, T, F)).astype(np.float32)
    target = rng.integers(4, V, (B, U)).astype(np.int32)
    tgt_lengths = rng.integers(2, U + 1, B).astype(np.int32)
    for b in range(B):
        target[b, tgt_lengths[b]:] = 1  # pad
    jd, pd = _dictionaries()
    prev = np.concatenate([np.full((B, 1), pd.eos(), np.int32), target[:, :-1]], 1)
    batch = {"src_frames": frames, "src_lengths": LENS, "target": target, "tgt_lengths": tgt_lengths,
             "prev_output_tokens": prev, "weight": np.ones(B, np.float32)}
    return JaxTransducerModel(jcfg), variables, model, batch, jd, pd


def test_bf16_encoder_output_matches_jax(setup, monkeypatch):
    """The encoder output of bf16 variables and frames: within BF16_ULPS
    bf16 ulps at the valid frames."""
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jmodel, variables, model, batch, _, _ = setup
    jvars = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), variables)
    want = jax.device_get(jax_o0.jit(lambda v, x: jmodel.apply(v, x, LENS, method="encode").encoder_out)(
        jvars, jnp.asarray(batch["src_frames"]).astype(jnp.bfloat16))).astype(np.float32)
    bf = TransducerModel(model.cfg)
    bf.load_state_dict(model.state_dict())
    bf = bf.to(torch.bfloat16).eval()
    with torch.no_grad():
        enc = bf.encode(torch.from_numpy(batch["src_frames"]).to(torch.bfloat16), torch.from_numpy(LENS))
    valid = enc.encoder_padding_mask.numpy()[..., None]
    err = np.abs(enc.encoder_out.float().numpy() - want) * valid
    assert err.max() <= _bf16_bound(want * valid), (err.max(), _bf16_bound(want * valid))


def test_bf16_train_step_loss_and_gradient_norm_match_jax(setup):
    """One train step of bf16 compute copies (fp32 masters, the fused RNNT
    criterion): the loss and the gradient norm against JAX's loss and
    gradient, its train step's microbatch function (``cast_floats`` of the
    masters, the criterion in train mode) by ``jax.value_and_grad``."""
    jmodel, variables, model, batch, jd, pd = setup
    jcfg, pcfg = JaxConfig(), EspressoConfig()
    for cfg in (jcfg, pcfg):
        cfg.criterion.name = "transducer_loss"
        cfg.common.dtype = "bfloat16"
    crit = jax_build_criterion(jcfg.criterion, _Task(jd))

    def loss(params):
        mb = dict({k: jnp.asarray(v) for k, v in batch.items()})
        mb["src_frames"] = mb["src_frames"].astype(jnp.bfloat16)
        out = crit(jmodel, {"params": cast_floats(params, jnp.bfloat16), "batch_stats": variables["batch_stats"]},
                   mb, rngs={"dropout": jax.random.PRNGKey(0)}, train=True)
        return out[0].astype(jnp.float32), out[1]

    (jloss, jsize), jgrads = jax.device_get(
        jax_o0.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"]))
    jnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in jax.tree_util.tree_leaves(jgrads)))
    jnorm /= float(jsize)
    pmodel = TransducerModel(model.cfg)
    pmodel.load_state_dict(model.state_dict())
    opt, _ = trainer.build_optimizer(pcfg)
    state = trainer.create_train_state(pmodel, opt, pcfg)
    step = trainer.make_train_step(pmodel, build_criterion(pcfg.criterion, _Task(pd)), opt, pcfg)
    _, m = step(state, {k: torch.from_numpy(v)[None] for k, v in batch.items()}, torch.Generator().manual_seed(0))
    assert m["sample_size"].item() == float(jsize) == B
    np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=STEP_RTOL)
    np.testing.assert_allclose(m["gnorm"].item(), jnorm, rtol=STEP_RTOL)


def test_bf16_beam_decode_matches_jax(setup, monkeypatch):
    """The AES beam (K = 4, beta 2, gamma 2.3) of bf16 variables on 8
    utterances, JAX's decoder on its plain path: each utterance's best
    score within SCORE_RTOL of JAX's (its tokens may be another near-tie's)
    and the hypotheses not empty."""
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jmodel, variables, model, batch, jd, pd = setup
    jvars = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), variables)
    frames = {"src_frames": batch["src_frames"], "src_lengths": LENS}
    with jit_o0():
        want = JaxBeamDecoder(jmodel, jd, fused_kernel="off", **BEAM).decode(jvars, frames)
    bf = TransducerModel(model.cfg)
    bf.load_state_dict(model.state_dict())
    got = TransducerBeamSearchDecoder(bf.to(torch.bfloat16).eval(), pd, **BEAM).decode(
        {k: torch.from_numpy(v) for k, v in frames.items()})
    assert sum(len(h[0]["tokens"]) for h in want) >= B and sum(len(h[0]["tokens"]) for h in got) >= B
    same = [np.array_equal(g[0]["tokens"], w[0]["tokens"]) for g, w in zip(got, want)]
    for b, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0]["score"], w[0]["score"], rtol=SCORE_RTOL,
                                   err_msg=f"utterance {b}; top hypotheses equal: {same}")
