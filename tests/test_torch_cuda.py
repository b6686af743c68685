"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (marked ``cuda``). Imports no JAX, so on a machine
without it the file runs on its own, without the suite's conftest (which
imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from espresso_tpu_torch.ops import decode_kernels as dk
from espresso_tpu_torch.ops import kernel_checks as kc
from espresso_tpu_torch.ops.attention_kernels import (
    rel_attention,
    rel_attention_reference,
)

pytestmark = pytest.mark.cuda

H, D = 8, 512  # the flagship's heads and width (d = 64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, seed, dev):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    key_valid = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid


@pytest.mark.parametrize("B,T", [(3, 2), (3, 37), (16, 156), (2, 1024)])
def test_rel_attention_kernel_matches_plain_version(dev, B, T):
    args = _inputs(B, T, seed=T, dev=dev) + (H, 0.125)
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


def test_rel_attention_rejects_what_it_does_not_take(dev):
    q_u, q_v, k, v, p, key_valid = _inputs(2, 8, seed=0, dev=dev)
    with pytest.raises(ValueError, match="bf16"):
        rel_attention(q_u.float(), q_v, k, v, p, key_valid, H, 0.125)
    with pytest.raises(ValueError, match="p "):
        rel_attention(q_u, q_v, k, v, p[:-1], key_valid, H, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        rel_attention(q_u, q_v, k, v, p, key_valid, 4, 0.125)


# ---------------------------------------------------------------------------
# the AES decode kernels (inputs and checks in ops/kernel_checks.py, which
# chip_smoke.py runs at the flagship shapes too)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,K,V,fold,bias",
    [
        (256, 10, 1024, False, False),
        (256, 10, 5003, False, False),
        (4, 4, 5003, True, True),
        (3, 1, 1024, False, True),
        (1, 4, 67, True, False),
    ],
)
def test_fused_joint_topk_kernel_matches_plain_version(dev, B, K, V, fold, bias):
    a = kc.joint_inputs(B, K, V, 512, 512, seed=V + K, dev=dev, bias=bias)
    kc.check_joint(a, K, K + 2, blank=0, eos=2, fold=fold)


@pytest.mark.parametrize("B,K,H_,L", [(256, 10, 512, 2), (1, 1, 64, 1), (3, 4, 128, 3)])
def test_lstm_step_reorder_kernel_matches_plain_version(dev, B, K, H_, L):
    kc.check_lstm(kc.lstm_inputs(B, K, H_, L, seed=B + H_, dev=dev), B, K)


@pytest.mark.parametrize("B,K", [(256, 10), (1, 1), (1, 4), (5, 20), (3, 40)])
def test_aes_merge_kernel_matches_plain_version(dev, B, K):
    kc.check_merge(kc.merge_inputs(B, K, seed=K, dev=dev))


@pytest.mark.parametrize(
    "T,B,K,n_exp", [(156, 256, 10, 2), (1, 1, 1, 1), (37, 3, 4, 1), (300, 2, 40, 3)]
)
def test_aes_backtrace_kernel_matches_plain_version(dev, T, B, K, n_exp):
    kc.check_backtrace(kc.backtrace_inputs(T, B, K, n_exp, V=1024, seed=T, dev=dev), n_exp)


def test_decode_kernels_reject_what_they_do_not_take(dev):
    a = kc.joint_inputs(2, 4, 128, 64, 64, seed=0, dev=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.fused_joint_topk(**dict(a, enc_t=a["enc_t"].float()), K=4, n_cand=6)
    with pytest.raises(ValueError, match="scores"):
        dk.fused_joint_topk(**dict(a, scores=a["scores"][:1]), K=4, n_cand=6)
    with pytest.raises(ValueError, match="n_cand"):
        dk.fused_joint_topk(**a, K=4, n_cand=33)
    s = kc.lstm_inputs(2, 4, 64, 2, seed=0, dev=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.lstm_step_reorder(**dict(s, S=s["S"].float()), B=2, K=4)
    with pytest.raises(ValueError, match="embedding width"):
        dk.lstm_step_reorder(**dict(s, x=s["x"][:, :32]), B=2, K=4)
    m = kc.merge_inputs(2, 4, seed=0, dev=dev)
    with pytest.raises(ValueError, match="float32"):
        dk.aes_merge(**dict(m, pool_scores=m["pool_scores"].double()), round_j=0)
    with pytest.raises(ValueError, match="pool_slot"):
        dk.aes_merge(**dict(m, pool_slot=m["pool_slot"][:, :3].contiguous()), round_j=0)
    b = kc.backtrace_inputs(5, 2, 4, 2, V=16, seed=0, dev=dev)
    with pytest.raises(ValueError, match="n_exp"):
        dk.aes_backtrace(**b, n_exp=1)
    with pytest.raises(ValueError, match="int32"):
        dk.aes_backtrace(**dict(b, etok=b["etok"].long()), n_exp=2)


# ---------------------------------------------------------------------------
# the training kernels (inputs and checks in ops/train_kernel_checks.py,
# which chip_smoke.py runs at the flagship shapes too)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T", [(16, 256), (3, 2), (3, 37), (2, 130)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_train_kernels_match_plain_versions(dev, B, T, rate):
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(B, T, seed=T, dev=dev)
    before = (ak.rel_attention_train_fwd.launches, ak.rel_attention_train_bwd.launches)
    tc.check_attention_train(a, H, rate)
    assert (ak.rel_attention_train_fwd.launches, ak.rel_attention_train_bwd.launches) == (
        before[0] + 1, before[1] + 1,
    )


@pytest.mark.parametrize(
    "B,T,U,V,blank",
    [(16, 256, 100, 1024, 0), (2, 37, 9, 5003, 131), (3, 5, 2, 67, 66), (1, 1, 0, 1024, 0)],
)
def test_rnnt_joint_kernels_match_plain_versions(dev, B, T, U, V, blank):
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    before = (rk.rnnt_joint_lp.launches, rk.rnnt_joint_bwd.launches)
    tc.check_rnnt_joint(tc.rnnt_inputs(B, T, U, 512, V, seed=V + T, dev=dev, blank=blank), blank)
    assert (rk.rnnt_joint_lp.launches, rk.rnnt_joint_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_train_kernels_reject_what_they_do_not_take(dev):
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(2, 8, seed=0, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"])
    with pytest.raises(ValueError, match="seed"):
        ak.rel_attention_train_fwd(*args, a["seed"].long(), H, 0.125, 0.1)
    with pytest.raises(ValueError, match="bf16"):
        ak.rel_attention_train_fwd(a["q_u"].float(), *args[1:], a["seed"], H, 0.125, 0.1)
    r = tc.rnnt_inputs(2, 4, 3, 64, 64, seed=0, dev=dev)
    with pytest.raises(ValueError, match="joint width"):
        rk.rnnt_joint_lp(r["enc_proj"], r["dec_proj"], r["fc_kernel"], r["fc_bias"], r["targets"], 0)
    r = tc.rnnt_inputs(2, 4, 3, 512, 64, seed=0, dev=dev)
    with pytest.raises(ValueError, match="transposed view"):
        rk.rnnt_joint_lp(r["enc_proj"], r["dec_proj"], r["fc_kernel"].contiguous(),
                         r["fc_bias"], r["targets"], 0)
