"""The recipes' LM stage on the port, against the JAX package on the CPU.

* ``prep binarize`` writes JAX's ``.bin``/``.idx`` byte for byte.
* ``LMTextDataset`` and ``LMBlockDataset`` (break modes none, complete and
  eos; ``group_specs`` at update_freq 2) give JAX's batches bit for bit.
* ``ops/losses.py`` and the cross-entropy criteria match JAX at uniform,
  unigram and temporal smoothing, with pads and zero-weight rows, at
  V = 5,003.
* A tiny LSTM LM (2 layers, H 32, V 43) through one and two train steps of
  two microbatches against JAX's ``make_train_step``: the loss, nll,
  ntokens, gradient norm and every updated weight; its valid step against
  JAX's ``make_valid_step``, with and without ``ema_validate``.
* The CLIs end to end on the port alone, on text and on ``.bin``: ``prep
  binarize``, ``cli.train`` (``task.name=language_modeling_for_asr``) for
  one epoch, ``cli.eval_lm``, whose nll equals JAX's valid step summed over
  JAX's batches on the checkpoint's weights; ``speech_recognize``'s
  ``build_lm`` loads the LM directory, and its logits are JAX's on those
  weights.

JAX's LMs get variables drawn in numpy on the shapes of their init
(``jax.eval_shape``: no init compile), carried into the port by
``bridge.load_jax_variables``. fp32 at dropout 0; torch on one thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_o0
from espresso_tpu.cli import prep as jax_prep
from espresso_tpu.config import EspressoConfig as JaxConfig
from espresso_tpu.criterions import build_criterion as jax_build_criterion
from espresso_tpu.data.dictionary import AsrDictionary as JaxDictionary
from espresso_tpu.data.indexed_dataset import LMBlockDataset as JaxBlockDataset
from espresso_tpu.data.lm_dataset import LMTextDataset as JaxTextDataset
from espresso_tpu.models.lstm_lm import LSTMLanguageModel as JaxLSTMLM
from espresso_tpu.models.lstm_lm import LSTMLMConfig as JaxLMConfig
from espresso_tpu.ops import losses as jax_losses
from espresso_tpu.train import trainer as jax_trainer
from espresso_tpu_torch.bridge import jax_state_dict, load_jax_variables
from espresso_tpu_torch.cli import prep as port_prep
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.criterions import build_criterion
from espresso_tpu_torch.data.dictionary import AsrDictionary
from espresso_tpu_torch.data.indexed_dataset import LMBlockDataset
from espresso_tpu_torch.data.lm_dataset import LMTextDataset
from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
from espresso_tpu_torch.ops import losses
from espresso_tpu_torch.train import checkpoint as ckpt
from espresso_tpu_torch.train import trainer
from test_torch_optim import write_lm_corpus

# fp32 on the CPU, summed in another order by each framework (the
# transducer step's bounds, tests/test_torch_train.py): the loss and the
# gradient norm to 1e-5 relative, an updated weight to 2e-6 absolute
RTOL, P_ATOL = 1e-5, 2e-6
UNITS = 40  # V = 43 with <pad>, </s>, <unk>
LM = dict(embed_dim=24, hidden_size=32, out_embed_dim=32, num_layers=2, dropout=0.0)
N_MICRO, B, U = 2, 3, 9
CLIP, LR, EMA = 0.1, 0.05, 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm"))
    write_lm_corpus(d, n_train=40, n_valid=12, units=UNITS)
    with open(os.path.join(d, "train.txt"), "a") as f:
        f.write("u00 <unk-word> u01\n\n")  # an OOV and a blank line
    return d


def _draw(rng, path, s):
    name = str(getattr(path[-1], "key", path[-1]))
    if name == "kernel":
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    if name == "embedding":
        return rng.standard_normal(s.shape).astype(np.float32)
    return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)


def _lm(vocab_size, seed=0):
    """(JAX LM, its variables drawn from ``seed``, the port's LM with them)."""
    cfg = JaxLMConfig(vocab_size=vocab_size, **LM)
    jlm = JaxLSTMLM(cfg)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), jnp.zeros((2, 3), jnp.int32))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(lambda p, s: _draw(rng, p, s), shapes)
    return jlm, variables, load_jax_variables(LSTMLanguageModel(LSTMLMConfig(vocab_size=vocab_size, **LM)),
                                              variables)


def test_binarize_writes_jax_bytes(corpus, tmp_path):
    text, dic = os.path.join(corpus, "train.txt"), os.path.join(corpus, "dict.txt")
    for extra in ([], ["--no-append-eos"]):
        assert jax_prep.binarize(["--text", text, "--dict", dic, "--output-prefix", f"{tmp_path}/j"] + extra) == 0
        assert port_prep.binarize(["--text", text, "--dict", dic, "--output-prefix", f"{tmp_path}/p"] + extra) == 0
        for ext in (".bin", ".idx"):
            got, want = (open(f"{tmp_path}/{w}{ext}", "rb").read() for w in "pj")
            assert got == want and want, (extra, ext)
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        port_prep.estimate_state_prior([])


def _same_batches(port_ds, jax_ds, update_freq, **kw):
    for epoch in (1, 2):
        specs = port_ds.make_batch_specs(seed=3, epoch=epoch, **kw)
        jspecs = jax_ds.make_batch_specs(seed=3, epoch=epoch, **kw)
        assert [(s.indices.tolist(), s.num_real, s.src_bucket, s.tgt_bucket) for s in specs] == \
            [(s.indices.tolist(), s.num_real, s.src_bucket, s.tgt_bucket) for s in jspecs]
        groups = port_ds.group_specs(specs, update_freq)
        assert len(groups) == len(jax_ds.group_specs(jspecs, update_freq))
        for g, jg in zip(groups, jax_ds.group_specs(jspecs, update_freq)):
            got, want = port_ds.collate_group(g), jax_ds.collate_group(jg)
            assert got.keys() == want.keys()
            for k, w in want.items():
                if isinstance(w, np.ndarray):
                    assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
                else:
                    assert got[k] == w, k


@pytest.mark.parametrize("source", ["text", "none", "complete", "eos"])
def test_lm_batches_match_jax(corpus, tmp_path, source):
    dic_path = os.path.join(corpus, "dict.txt")
    dic, jdic = AsrDictionary.load(dic_path), JaxDictionary.load(dic_path)
    text = os.path.join(corpus, "train.txt")
    if source == "text":
        port_ds, jax_ds = LMTextDataset(text, dic), JaxTextDataset(text, jdic)
    else:
        port_prep.binarize(["--text", text, "--dict", dic_path, "--output-prefix", f"{tmp_path}/t"])
        port_ds = LMBlockDataset(f"{tmp_path}/t", dic, block_size=16, break_mode=source)
        jax_ds = JaxBlockDataset(f"{tmp_path}/t", jdic, block_size=16, break_mode=source)
        assert np.array_equal(port_ds.slices, jax_ds.slices)
    assert len(port_ds) == len(jax_ds) and np.array_equal(port_ds.src_sizes, jax_ds.src_sizes)
    _same_batches(port_ds, jax_ds, 2, max_tokens=60, max_sentences=None, num_buckets=3,
                  required_batch_size_multiple=2)
    _same_batches(port_ds, jax_ds, 1, max_tokens=None, max_sentences=5, num_buckets=2, shuffle=False)


class _Dictionary:
    """The criteria's view of a dictionary: pad and the unigram counts."""

    def __init__(self, V):
        self.count = list(np.random.default_rng(1).integers(1, 100, V))

    def pad(self):
        return 1


class _Task:
    def __init__(self, V):
        self.dictionary = _Dictionary(V)


@pytest.mark.parametrize("smoothing", ["none", "uniform", "unigram", "temporal"])
def test_losses_and_criteria_match_jax(smoothing):
    """The losses at V = 5,003 with pads and a zero-weight row; the
    criterion on the LM's logits, the same terms."""
    V, rng = 5003, np.random.default_rng(7)
    logits = (3 * rng.standard_normal((3, 11, V))).astype(np.float32)
    target = rng.integers(2, V, (3, 11)).astype(np.int32)
    target[0, 8:] = 1
    target[1, 4] = 1
    weight = np.array([1.0, 1.0, 0.0], np.float32)
    mask = (target != 1) & (weight[:, None] > 0)
    t = lambda x: torch.from_numpy(x)
    if smoothing == "none":
        got = losses.cross_entropy_loss(t(logits), t(target), t(mask))
        want = jax_losses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask))
    else:
        counts = _Dictionary(V).count
        uni = losses.unigram_probs_from_counts(counts, 1.0, 1)
        assert np.array_equal(uni, jax_losses.unigram_probs_from_counts(counts, 1.0, 1))
        got = losses.label_smoothed_cross_entropy(t(logits), t(target), t(mask), 0.1, smoothing, 1, t(uni))
        want = jax_losses.label_smoothed_cross_entropy(
            jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask), 0.1, smoothing, 1, jnp.asarray(uni))
        if smoothing == "temporal":
            np.testing.assert_array_equal(
                losses.temporal_smoothing_weights(t(target), V, 1).numpy(),
                np.asarray(jax_losses.temporal_smoothing_weights(jnp.asarray(target), V, 1)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)

    # the criteria on those logits as an LM batch's (a model that returns
    # them), the zero-weight row and pads masked
    batch = {"prev_output_tokens": target, "target": target, "weight": weight}
    cfgs = (JaxConfig(), EspressoConfig())
    for cfg in cfgs:
        cfg.criterion.name = "cross_entropy_v2" if smoothing == "none" else "label_smoothed_cross_entropy_v2"
        cfg.criterion.label_smoothing = 0.1
        cfg.criterion.smoothing_type = "uniform" if smoothing == "none" else smoothing
    jmodel = type("M", (), {"apply": staticmethod(lambda variables, tokens, **kw: jnp.asarray(logits))})
    jloss, jsize, jlog, _ = jax_build_criterion(cfgs[0].criterion, _Task(V))(
        jmodel, {"params": {}}, {k: jnp.asarray(v) for k, v in batch.items()})
    crit = build_criterion(cfgs[1].criterion, _Task(V))
    loss, size, log = crit(lambda tokens: t(logits), {k: t(v) for k, v in batch.items()})
    assert int(size) == int(jsize) == int(log["ntokens"]) == int(mask.sum())
    for g, w in ((loss, jloss), (log["nll_loss"], jlog["nll_loss"])):
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)
    # a speech batch goes through the encoder-decoder's teacher-forced
    # forward, (logits, encoder output), with the scheduled-sampling rate
    seen = {}

    def speech_model(frames, lengths, tokens, ss_prob=1.0):
        seen.update(frames=frames, lengths=lengths, ss_prob=ss_prob)
        return t(logits), None

    speech = {"src_frames": t(np.zeros((3, 4, 2), np.float32)), "src_lengths": t(np.ones(3, np.int32)),
              **{k: t(v) for k, v in batch.items()}}
    loss2, size2, _ = crit(speech_model, speech, ss_prob=0.7)
    assert float(loss2) == float(loss) and int(size2) == int(size) and seen["ss_prob"] == 0.7
    assert seen["frames"] is speech["src_frames"] and seen["lengths"] is speech["src_lengths"]


def _configs():
    jcfg, pcfg = JaxConfig(), EspressoConfig()
    for cfg in (jcfg, pcfg):
        cfg.common.dtype = "float32"
        cfg.criterion.name = "cross_entropy_v2"
        cfg.optimization.clip_norm = CLIP
        cfg.optimization.lr = [LR]
        cfg.optimization.ema_decay = EMA
        cfg.optimizer.name = "nag"
        cfg.optimizer.momentum = 0.9
    return jcfg, pcfg


def _step_batch(rng, V):
    target = rng.integers(3, V, (N_MICRO, B, U)).astype(np.int32)
    lengths = np.array([[U, 5, 2], [7, U, 1]], np.int32)
    target[np.arange(U)[None, None, :] >= lengths[..., None]] = 1
    prev = np.concatenate([np.full((N_MICRO, B, 1), 2, np.int32), target[..., :-1]], -1)
    return {"target": target, "prev_output_tokens": prev, "tgt_lengths": lengths,
            "src_lengths": lengths.copy(), "weight": np.array([[1, 1, 1], [1, 1, 0]], np.float32)}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX: the LM's variables, a two-microbatch batch, two train steps, and
    the valid step's sums with and without the EMA weights."""
    V = UNITS + 3
    jlm, variables, _ = _lm(V, seed=0)
    batch = _step_batch(np.random.default_rng(5), V)
    jcfg, _ = _configs()
    optimizer, _ = jax_trainer.build_optimizer(jcfg)
    criterion = jax_build_criterion(jcfg.criterion, _Task(V))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.01, params)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=optimizer.init(params), ema_params=ema, overflow_count=jnp.zeros((), jnp.int32))
    mb0 = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    valid = {}
    for use_ema in (False, True):
        jcfg.optimization.ema_validate = use_ema
        valid[use_ema] = jax.device_get(jax_trainer.make_valid_step(jlm, criterion, jcfg)(state, mb0))
    state = state.replace(ema_params=jax.tree_util.tree_map(jnp.copy, params))
    step = jax_o0.jit(jax_trainer.make_train_step(jlm, criterion, optimizer, jcfg, ema_decay=EMA))
    out = []
    for _ in range(2):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        out.append((jax.device_get(state), jax.device_get(metrics)))
    return variables, batch, out, valid


def test_lm_train_steps_match_jax(jax_steps):
    variables, batch, out, _ = jax_steps
    V = UNITS + 3
    _, pcfg = _configs()
    model = load_jax_variables(LSTMLanguageModel(LSTMLMConfig(vocab_size=V, **LM)), variables)
    optimizer, _ = trainer.build_optimizer(pcfg)
    state = trainer.create_train_state(model, optimizer, pcfg)
    step = trainer.make_train_step(model, build_criterion(pcfg.criterion, _Task(V)), optimizer, pcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, (jstate, jm) in enumerate(out):
        state, m = step(state, tb, torch.Generator().manual_seed(0))
        for k in ("loss", "nll_loss", "ntokens", "sample_size", "gnorm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=RTOL, err_msg=f"step {i + 1}: {k}")
        assert m["gnorm"].item() > CLIP  # the clip acts
        want = jax_state_dict({"params": jstate.params})
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=RTOL, atol=P_ATOL,
                                       err_msg=f"step {i + 1}: {name}")
    assert int(state.opt_state.count) == 2 and state.step == 2


def test_lm_valid_step_matches_jax(jax_steps):
    variables, batch, _, valid = jax_steps
    V = UNITS + 3
    _, pcfg = _configs()
    model = load_jax_variables(LSTMLanguageModel(LSTMLMConfig(vocab_size=V, **LM)), variables)
    optimizer, _ = trainer.build_optimizer(pcfg)
    state = trainer.create_train_state(model, optimizer, pcfg)
    state.ema_params.mul_(0.5).add_(0.01)
    mb0 = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    crit = build_criterion(pcfg.criterion, _Task(V))
    for use_ema, want in valid.items():
        pcfg.optimization.ema_validate = use_ema
        got = trainer.make_valid_step(model, crit, pcfg)(state, mb0)
        for k in ("loss", "nll_loss", "ntokens", "sample_size"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, err_msg=f"ema {use_ema}: {k}")
    assert float(valid[True]["loss"]) != float(valid[False]["loss"])


@pytest.mark.parametrize("source", ["text", "bin"])
def test_lm_stage_clis_end_to_end(corpus, tmp_path, source):
    """prep binarize -> cli.train for one epoch -> cli.eval_lm on the valid
    split; eval_lm's nll is JAX's valid step summed over JAX's batches of
    the split on the checkpoint's weights, and speech_recognize's build_lm
    gives JAX's logits on them."""
    from espresso_tpu_torch.cli import eval_lm, speech_recognize, train

    d = str(tmp_path)
    for name in ("dict.txt", "train.txt", "valid.txt"):
        with open(os.path.join(corpus, name)) as f, open(os.path.join(d, name), "w") as g:
            g.write(f.read())
    dic_path = os.path.join(d, "dict.txt")
    if source == "bin":
        for split in ("train", "valid"):
            port_prep.main(["binarize", "--text", f"{d}/{split}.txt", "--dict", dic_path,
                            "--output-prefix", f"{d}/{split}"])
    save = f"{d}/lm"
    data = [f"dataset.data={d}", "dataset.tokens_per_sample=16", "common.dtype=float32",
            "dataset.num_batch_buckets=1"]
    model_args = ["model.name=lstm_lm_wsj"] + [f"model.{k}={v}" for k, v in LM.items()]
    train.main(data + model_args + ["task.name=language_modeling_for_asr", "criterion.name=cross_entropy_v2",
                                    "optimization.max_epoch=1", "dataset.batch_size=8",
                                    f"checkpoint.save_dir={save}", "optimization.lr=0.01"], device="cpu")
    res = eval_lm.main(data + ["task.name=language_modeling_for_asr", f"checkpoint.save_dir={save}",
                               "dataset.gen_subset=valid"], device="cpu")

    raw = ckpt.load_raw_checkpoint(f"{save}/checkpoint_last")
    assert int(raw["step"]) > 0
    jdic = JaxDictionary.load(dic_path)
    V = len(jdic)
    jds = (JaxBlockDataset(f"{d}/valid", jdic, block_size=16) if source == "bin"
           else JaxTextDataset(f"{d}/valid.txt", jdic))
    jlm = JaxLSTMLM(JaxLMConfig(vocab_size=V, **LM))
    jcfg = JaxConfig()
    jcfg.common.dtype, jcfg.criterion.name = "float32", "cross_entropy_v2"
    criterion = jax_build_criterion(jcfg.criterion, type("T", (), {"dictionary": jdic})())
    params = jax.tree_util.tree_map(jnp.asarray, raw["params"])
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                   opt_state=None, ema_params=None, overflow_count=None)
    valid = jax_o0.jit(jax_trainer.make_valid_step(jlm, criterion, jcfg))
    nll = tokens = 0.0
    for spec in jds.make_batch_specs(max_tokens=None, max_sentences=32, shuffle=False):
        stats = valid(state, {k: jnp.asarray(v) for k, v in jds.collate(spec).items() if isinstance(v, np.ndarray)})
        nll += float(stats["nll_loss"])
        tokens += float(stats["ntokens"])
    assert res["ntokens"] == tokens > 0
    np.testing.assert_allclose(res["nll_loss"], nll / tokens, rtol=RTOL)
    np.testing.assert_allclose(res["ppl"], np.exp(nll / tokens), rtol=2 * RTOL)

    # the loop closes: the decode CLI's LM from this directory
    gen = EspressoConfig()
    gen.generation.lm_path, gen.common.dtype = save, "float32"
    lm = speech_recognize.build_lm(gen, None, device="cpu")
    assert lm.cfg.vocab_size == V == len(AsrDictionary.load(dic_path, enable_bos=True)) - 1
    toks = np.random.default_rng(0).integers(0, V, (2, 7)).astype(np.int32)
    with torch.no_grad():
        got = lm(torch.from_numpy(toks).long()).numpy()
    want = np.asarray(jlm.apply({"params": params}, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
