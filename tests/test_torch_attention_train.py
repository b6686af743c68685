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


def test_train_mode_attention_takes_only_square_self_attention():
    mha = MultiheadAttention(D, H, dropout=0.1).train()
    x = torch.randn(B, 6, D)
    rel = torch.randn(11, D)
    out, _ = mha(x, x, x, rel)
    assert out.shape == (B, 6, D)
    with pytest.raises(NotImplementedError):
        mha(x, x, x, rel, attn_mask=torch.zeros(6, 6))
    with pytest.raises(NotImplementedError):
        mha(x[:, :3], x, x, rel)
