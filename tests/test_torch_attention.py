"""Parity of the port's relative-position attention against the JAX package.

- the port's ``MultiheadAttention`` (fp32, CPU) against JAX
  ``MultiheadAttention`` on its plain path (ESPRESSO_FUSED_ATTN=off), through
  the kernel dispatch and through the gather path (weights, additive mask);
- the port's plain ``rel_attention_reference`` on bf16 inputs against the
  JAX Pallas kernel ``rel_attention_fused`` run in interpret mode.

The CUDA kernel against its plain version is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.modules.attention import MultiheadAttention as JaxMHA
from espresso_tpu.ops.attention_kernels import rel_attention_fused
from espresso_tpu_torch.bridge import load_jax_variables
from espresso_tpu_torch.modules.attention import MultiheadAttention
from espresso_tpu_torch.ops.attention_kernels import (
    rel_attention,
    rel_attention_reference,
)

B, T, H, D = 3, 12, 2, 128  # d = 64: the JAX kernel gate and the CUDA kernel's width
LENS = np.array([12, 9, 5])

# bf16 bound between two implementations that round at the same points but
# sum in another order: a flipped rounding of one score moves an output by
# about one bf16 ulp of the output (2**-7 at magnitudes in [1, 2)); allow 2.
BF16_OUT_ATOL = 2 * 2.0 ** -7


def _flat_inputs(T, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(dtype)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    key_valid = np.arange(T)[None, :] < lens[:, None]
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid


@pytest.mark.parametrize("path", ["kernel", "need_weights", "attn_mask"])
def test_mha_matches_jax_plain_path(path, monkeypatch):
    monkeypatch.setenv("ESPRESSO_FUSED_ATTN", "off")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    rel = rng.standard_normal((2 * T - 1, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < LENS[:, None]
    attn_mask = None
    if path == "attn_mask":
        attn_mask = np.where(np.tril(np.ones((T, T), bool), 3), 0.0, -1e8).astype(np.float32)
    jmod = JaxMHA(D, H, use_relative_pos=True)
    variables = jmod.init(jax.random.PRNGKey(0), x, x, x, key_padding_mask=mask, rel_pos=rel)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables,
    )  # non-zero pos_bias_u / pos_bias_v
    j_out, j_w, _ = jmod.apply(
        variables, x, x, x,
        key_padding_mask=mask,
        attn_mask=None if attn_mask is None else jnp.asarray(attn_mask),
        rel_pos=rel,
        need_weights=path == "need_weights",
    )
    mod = load_jax_variables(MultiheadAttention(D, H).eval(), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, w = mod(
            xt, xt, xt, torch.from_numpy(rel),
            key_padding_mask=torch.from_numpy(mask),
            attn_mask=None if attn_mask is None else torch.from_numpy(attn_mask),
            need_weights=path == "need_weights",
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    if path == "need_weights":
        np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T_", [2, 12, 37])
def test_reference_bf16_matches_jax_fused_interpret(T_):
    q_u, q_v, k, v, p, key_valid = _flat_inputs(T_, seed=T_)
    scale = (D // H) ** -0.5
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    j_out = rel_attention_fused(
        bf(q_u), bf(q_v), bf(k), bf(v), bf(p), jnp.asarray(key_valid), H, scale,
        interpret=True,
    )
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = rel_attention_reference(
        tb(q_u), tb(q_v), tb(k), tb(v), tb(p), torch.from_numpy(key_valid), H, scale
    )
    j = np.asarray(j_out.astype(jnp.float32))
    o = out.float().numpy()
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o, j, rtol=0, atol=BF16_OUT_ATOL)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    q_u, q_v, k, v, p, key_valid = (torch.from_numpy(a) for a in _flat_inputs(T, seed=5))
    before = rel_attention.launches
    out = rel_attention(q_u, q_v, k, v, p, key_valid, H, 0.125)
    ref = rel_attention_reference(q_u, q_v, k, v, p, key_valid, H, 0.125)
    assert torch.equal(out, ref)
    assert rel_attention.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    """Only a CPU tensor takes the plain version; any other non-CUDA device
    raises instead of falling back."""
    args = [torch.from_numpy(a).to("meta") for a in _flat_inputs(T, seed=6)]
    with pytest.raises(ValueError, match="unsupported device"):
        rel_attention(*args, H, 0.125)
