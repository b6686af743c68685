"""Parity of the port's RNNT loss and joint kernels' plain versions with JAX.

- the plain ``rnnt_joint_lp`` against the JAX Pallas ``rnnt_joint_lp`` in
  interpret mode (the JAX kernel needs V % 128 == 0), with the blank in the
  first and in the second V tile;
- the fused loss (``RnntLossFused``: the plain joint kernels and the DP) and
  its four gradients against JAX ``rnnt_loss_fused_pallas`` in interpret
  mode at V=256, and against the XLA chunked ``rnnt_loss_fused_xla`` at the
  ragged V=5003, with ragged source and target lengths;
- the DP alone (``_forward_alpha``, ``_backward_beta``) and the lattice
  ``rnnt_loss`` with its gradient against ``espresso_tpu/ops/rnnt.py``.

Everything is fp32 on the CPU. The CUDA kernels against these plain
versions are in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from espresso_tpu.ops import rnnt as jax_rnnt
from espresso_tpu.ops.rnnt_fused import rnnt_loss_fused_xla
from espresso_tpu.ops.rnnt_pallas import rnnt_joint_lp as jax_joint_lp
from espresso_tpu.ops.rnnt_pallas import rnnt_loss_fused_pallas
from espresso_tpu_torch.ops import rnnt as port_rnnt
from espresso_tpu_torch.ops.rnnt_fused import RnntLossFused
from espresso_tpu_torch.ops.rnnt_kernels import rnnt_joint_lp

B, T, U, J = 2, 5, 3, 128
SRC = np.array([5, 3], np.int32)
TGT = np.array([3, 2], np.int32)
# tests/test_rnnt_fused.py:114-121's bounds: values to rtol 1e-5 and atol
# 1e-4 (fp32 logsumexps over V summed in another order), gradients to 2e-4
# of their largest magnitude
RTOL, ATOL, GRAD_REL = 1e-5, 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(V, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, J)).astype(np.float32),
        rng.standard_normal((B, U + 1, J)).astype(np.float32),
        (0.1 * rng.standard_normal((J, V))).astype(np.float32),
        (0.1 * rng.standard_normal(V)).astype(np.float32),
        rng.integers(1, V, (B, U)).astype(np.int32),
    )


@pytest.mark.parametrize("blank", [0, 131])
def test_joint_lp_matches_jax_kernel(blank):
    e, d, w, b, tgt = _inputs(256, seed=blank)
    lpb, lpl, lse = jax_joint_lp(*(jnp.asarray(x) for x in (e, d, w, b, tgt)), blank, interpret=True)
    got = rnnt_joint_lp(*(torch.from_numpy(x) for x in (e, d, w, b, tgt)), blank)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(lpb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(lpl), rtol=RTOL, atol=ATOL)
    # the JAX kernel's lse is its padded [B, U1p, Tp] layout
    lse_j = np.moveaxis(np.asarray(lse), 2, 1)[:, :T, : U + 1]
    np.testing.assert_allclose(got[2].numpy(), lse_j, rtol=RTOL, atol=ATOL)
    assert (got[1][..., U] == port_rnnt.NEG_INF).all()


def _check_loss_and_grads(jax_loss_fn, V, blank, seed):
    e, d, w, b, tgt = _inputs(V, seed)
    src, tl = jnp.asarray(SRC), jnp.asarray(TGT)

    def total(*a):
        return jax_loss_fn(*a, jnp.asarray(tgt), src, tl).sum()

    want, grads = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x) for x in (e, d, w, b))
    )
    leaves = [torch.from_numpy(x).requires_grad_() for x in (e, d, w, b)]
    losses = RnntLossFused.apply(
        *leaves, torch.from_numpy(tgt), torch.from_numpy(SRC), torch.from_numpy(TGT), blank
    )
    losses.sum().backward()
    np.testing.assert_allclose(losses.sum().item(), float(want), rtol=RTOL, atol=ATOL)
    for name, leaf, g in zip(("enc_proj", "dec_proj", "fc_kernel", "fc_bias"), leaves, grads):
        g = np.asarray(g)
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (name, err, np.abs(g).max())


def test_fused_loss_matches_jax_pallas_loss():
    # the blank in the second V tile (blank 0 is held by the test below)
    _check_loss_and_grads(
        lambda *a: rnnt_loss_fused_pallas(*a, 131, True), V=256, blank=131, seed=1
    )


def test_fused_loss_matches_jax_chunked_loss_at_ragged_vocab():
    _check_loss_and_grads(lambda *a: rnnt_loss_fused_xla(*a, 0), V=5003, blank=0, seed=2)


def test_dp_and_lattice_loss_match_jax():
    rng = np.random.default_rng(3)
    V = 11
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    tgt = rng.integers(1, V, (B, U)).astype(np.int32)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    jb, jl = jax_rnnt._gather_transitions(lp, jnp.asarray(tgt), 0)
    j_alpha, j_logz = jax.jit(jax_rnnt._forward_alpha)(jb, jl, jnp.asarray(SRC), jnp.asarray(TGT))
    j_beta = jax.jit(jax_rnnt._backward_beta)(jb, jl, jnp.asarray(SRC), jnp.asarray(TGT))
    pb, pl = port_rnnt._gather_transitions(
        torch.from_numpy(np.array(lp)), torch.from_numpy(tgt), 0
    )
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    p_alpha, p_logz = port_rnnt._forward_alpha(pb, pl, torch.from_numpy(SRC), torch.from_numpy(TGT))
    p_beta = port_rnnt._backward_beta(pb, pl, torch.from_numpy(SRC), torch.from_numpy(TGT))
    for got, want in ((p_alpha, j_alpha), (p_logz, j_logz), (p_beta, j_beta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the lattice loss and its gradient
    want, g_want = jax.jit(jax.value_and_grad(
        lambda x: jax_rnnt.rnnt_loss(x, jnp.asarray(tgt), jnp.asarray(SRC), jnp.asarray(TGT)).sum()
    ))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = port_rnnt.rnnt_loss(x, torch.from_numpy(tgt), torch.from_numpy(SRC), torch.from_numpy(TGT))
    loss.sum().backward()
    np.testing.assert_allclose(loss.sum().item(), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=RTOL, atol=ATOL)
