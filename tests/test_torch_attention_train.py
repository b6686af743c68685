"""Parity of the port's train-mode attention against the JAX train kernels.

- ``dropout_keep_mask`` (the port's replay of the in-kernel hash) equal to
  JAX's, bit for bit, over several (seed, item, head, T);
- the plain forward ``rel_attention_train_reference`` on bf16 inputs
  against the JAX Pallas ``rel_attention_train`` in interpret mode, at rates
  0 and 0.1, with a ragged key mask;
- the plain backward against ``jax.vjp`` of the same, all five gradients;
- the attention module in train mode takes only square self-attention.

The CUDA kernels against these plain versions are in test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.ops import attention_kernels as jax_kernels
from espresso_tpu_torch.modules.attention import MultiheadAttention
from espresso_tpu_torch.ops import attention_kernels as kernels
from espresso_tpu_torch.ops.train_kernel_checks import bf16_ulp

B, H, d = 2, 2, 64
D = H * d
SEED = 1234
# both implementations round at the same points, so they agree bit for bit
# today; the bound allows a flipped rounding of one score or weight, which
# moves a result by about one bf16 ulp of its largest magnitude: 2 ulps
ULPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(T: int, rate: float):
    """Inputs (numpy, bf16-representable f32) and JAX's output and five
    gradients through the interpreted kernels."""
    rng = np.random.default_rng(T)
    mk = lambda *s: np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16), np.float32)
    qu, qv, k, v, g = (mk(B, T, D) for _ in range(5))
    p = mk(2 * T - 1, D)
    key_valid = np.arange(T)[None, :] < np.array([T, T // 2 + 1])[:, None]
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)

    def f(a, b, c, e, pp):
        return jax_kernels.rel_attention_train(
            a, b, c, e, pp, jnp.asarray(key_valid), jnp.int32(SEED), H, d ** -0.5, rate, True
        )

    @jax.jit
    def fwd_bwd(*args):
        out, vjp = jax.vjp(f, *args[:5])
        return out, vjp(args[5])

    out, grads = fwd_bwd(bf(qu), bf(qv), bf(k), bf(v), bf(p), bf(g))
    grads = [np.asarray(x, np.float32) for x in grads]
    return (qu, qv, k, v, p, key_valid, g), np.asarray(out, np.float32), grads


def _torch_args(inputs):
    qu, qv, k, v, p, key_valid, g = inputs
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    return (tb(qu), tb(qv), tb(k), tb(v), tb(p), torch.from_numpy(key_valid)), tb(g)


def _assert_close(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.float().numpy()
    bound = ULPS * bf16_ulp(float(np.abs(want).max()))
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max error {err} > {bound}"


@pytest.mark.parametrize(
    "seed,item,head,T", [(0, 0, 0, 8), (123456789, 3, 7, 17), (2**31 - 2, 15, 5, 33), (42, 1, 1, 64)]
)
def test_dropout_keep_mask_equals_jax(seed, item, head, T):
    for rate in (0.1, 0.3):
        want = np.asarray(jax_kernels.dropout_keep_mask(seed, item, head, T, T + 3, rate))
        got = kernels.dropout_keep_mask(seed, item, head, T, T + 3, rate).numpy()
        np.testing.assert_array_equal(got, want)
    bits = np.asarray(jax_kernels._keep_mask_tile(jnp.int32(seed), item, head, T, T))
    np.testing.assert_array_equal(kernels.keep_mask_tile(seed, item, head, T, T).numpy(), bits)


@pytest.mark.parametrize("T,rate", [(8, 0.0), (17, 0.1)])
def test_train_forward_matches_jax_kernel(T, rate):
    inputs, want, _ = _case(T, rate)
    args, _ = _torch_args(inputs)
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = kernels.rel_attention_train_reference(*args, H, d ** -0.5, rate, seed)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, D)
    _assert_close(out, want, "out")
    # the autograd function takes the same path on a CPU tensor
    _assert_close(kernels.rel_attention_train(*args, seed, H, d ** -0.5, rate), want, "fn")


@pytest.mark.parametrize("T,rate", [(8, 0.0), (17, 0.1)])
def test_train_backward_matches_jax_vjp(T, rate):
    inputs, _, want = _case(T, rate)
    args, g = _torch_args(inputs)
    seed = torch.tensor([SEED], dtype=torch.int32)
    got = kernels.rel_attention_train_backward_reference(*args, g, H, d ** -0.5, rate, seed)
    for name, x, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, want):
        assert x.dtype == torch.bfloat16
        _assert_close(x, w, name)
    # through autograd
    leaves = [a.clone().requires_grad_() for a in args[:5]]
    out = kernels.rel_attention_train(*leaves, args[5], seed, H, d ** -0.5, rate)
    out.backward(g)
    for name, leaf, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), leaves, want):
        _assert_close(leaf.grad, w, f"autograd {name}")


def test_train_mode_attention_takes_only_square_self_attention(monkeypatch):
    """In train mode only square relative self-attention without an
    additive mask or weights reaches the train kernels; a mask or a
    non-square call takes the plain path (at dropout 0 the eval-mode
    result)."""
    from espresso_tpu_torch.modules import attention

    calls = []

    def recorded(*args):
        calls.append(args[0].shape)
        return kernels.rel_attention_train(*args)

    monkeypatch.setattr(attention, "rel_attention_train", recorded)
    mha = MultiheadAttention(D, H, dropout=0.1).train()
    x = torch.randn(B, 6, D)
    rel = torch.randn(11, D)
    out, _ = mha(x, x, x, rel)
    assert out.shape == (B, 6, D) and len(calls) == 1
    mha.dropout.rate = 0.0
    mask = torch.where(torch.rand(6, 6) < 0.7, 0.0, -1e8)
    for args, kw in (((x, x, x, rel), dict(attn_mask=mask)), ((x[:, :3], x, x, rel), {})):
        with torch.no_grad():
            got, _ = mha.train()(*args, **kw)
            want, _ = mha.eval()(*args, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(calls) == 1


# two conformer layers whose relative table is clipped below the length:
# encoder_relative_max_size 8 at T' = 20 (the flagship clips at 1024)
CLIP_L, CLIP_T, CLIP_FFN, CLIP_K = 8, 20, 256, 3


@functools.lru_cache(maxsize=None)
def _clipped_layers():
    """Two JAX conformer layers, their variables perturbed from a numpy
    seed, the inputs, and the relative table clipped at CLIP_L."""
    from espresso_tpu.modules.conformer import ConformerEncoderLayer as JaxLayer
    from espresso_tpu.modules.positional import RelativePositionalEmbedding as JaxRelPos

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, CLIP_T, D)).astype(np.float32)
    mask = np.arange(CLIP_T)[None, :] < np.array([CLIP_T, 13])[:, None]
    rel = np.array(JaxRelPos(D, max_size=CLIP_L).apply({}, CLIP_T))
    assert rel.shape == (2 * CLIP_L - 1, D)
    jlayer = JaxLayer(D, CLIP_FFN, H, depthwise_kernel_size=CLIP_K)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if str(getattr(path[-1], "key", path[-1])) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)

    init = jax.device_get(jax.jit(jlayer.init)(jax.random.PRNGKey(0), x, mask, None, rel))
    variables = [jax.tree_util.tree_map_with_path(perturb, init) for _ in range(2)]
    return jlayer, variables, x, mask, rel


def _port_layers(variables, train: bool):
    from espresso_tpu_torch.bridge import load_jax_variables
    from espresso_tpu_torch.modules.conformer import ConformerEncoderLayer

    layers = [
        load_jax_variables(ConformerEncoderLayer(D, CLIP_FFN, H, CLIP_K), v) for v in variables
    ]
    return [layer.train(train) for layer in layers]


@pytest.mark.parametrize("train", [False, True])
def test_clipped_table_layers_match_jax(train, monkeypatch):
    """At T' above the table's size the port's layers take the kernels
    (plain versions here) on the expanded table and agree with JAX's own
    non-fused path: the clipped gather in eval, the clipped skew in train
    (the output, and the gradients of the projections q, k, v and pos)."""
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    jlayer, variables, x, mask, rel = _clipped_layers()
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    proj = ("q_proj", "k_proj", "v_proj", "pos_proj")

    def jax_loss(params):
        h = jnp.asarray(x)
        for p, v in zip(params, variables):
            args = ({**v, "params": p}, h, jnp.asarray(mask), None, jnp.asarray(rel))
            # train: batch statistics of the batch, as the port's train mode
            h = jlayer.apply(*args, train=True, mutable=["batch_stats"])[0] if train else (
                jlayer.apply(*args)
            )
        return jnp.sum(h * g), h

    params = [v["params"] for v in variables]
    if train:
        (_, j_out), j_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    else:
        j_out = jax.jit(jax_loss)(params)[1]
    layers = _port_layers(variables, train)
    h = torch.from_numpy(x)
    for layer in layers:
        h = layer(h, torch.from_numpy(mask), torch.from_numpy(rel))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)
    if not train:
        return
    (h * torch.from_numpy(g)).sum().backward()
    for layer, jg in zip(layers, j_grads):
        for name in proj:
            got = getattr(layer.self_attn, name).weight.grad.t().numpy()
            want = np.asarray(jg["self_attn"][name]["kernel"])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4, err_msg=name)
