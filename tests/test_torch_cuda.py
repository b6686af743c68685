"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card. Imports no JAX, so on a machine without it the
file runs on its own, without the suite's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from espresso_tpu_torch.ops.attention_kernels import (
    rel_attention,
    rel_attention_reference,
)

H, D = 8, 512  # the flagship's heads and width (d = 64)


def _inputs(B, T, seed, dev):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    key_valid = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid


@pytest.mark.parametrize("B,T", [(3, 2), (3, 37), (16, 156), (2, 1024)])
def test_rel_attention_kernel_matches_plain_version(B, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(B, T, seed=T, dev=torch.device("cuda")) + (H, 0.125)
    before = rel_attention.launches
    out = rel_attention(*args)
    torch.cuda.synchronize()
    assert rel_attention.launches == before + 1
    ref = rel_attention_reference(*args)
    # two bf16 ulps at the output's magnitude (|out| < 4 here): the kernel
    # and the plain version round at the same points but sum in another order
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err <= 2 * 2.0 ** -6, err


def test_rel_attention_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q_u, q_v, k, v, p, key_valid = _inputs(2, 8, seed=0, dev=torch.device("cuda"))
    with pytest.raises(ValueError, match="bf16"):
        rel_attention(q_u.float(), q_v, k, v, p, key_valid, H, 0.125)
    with pytest.raises(ValueError, match="p "):
        rel_attention(q_u, q_v, k, v, p[:-1], key_valid, H, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        rel_attention(q_u, q_v, k, v, p, key_valid, 4, 0.125)
