"""Inputs and checks that hold each AES decode kernel against its plain
version on the card, shared by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Each ``*_inputs`` makes seeded inputs at a given shape on a given device;
each ``check_*`` runs the wrapper (which must launch its kernel once) and
the plain version on the same inputs, raises ``AssertionError`` on a
disagreement beyond the stated bound, and returns the max error.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from espresso_tpu_torch.ops import decode_kernels as dk

NEG = dk.NEG_INF
# fused_joint_topk: the kernel sums the joint's products in another order
# than the plain version, so an element of the bf16 joint hidden can round
# to the neighbouring value; a flip moves a logit by |w_out| * 2**-8 * |h|,
# ~1e-3 at these scales: 0.02 bounds values, blank log-probs and factors
JOINT_TOL = 0.02
# lstm_step_reorder: pre sums in another order in the kernel than in the
# plain version, so a pre, a gate or a state value can round to the
# neighbouring bf16 value; the state's error stays within a few bf16 ulps of
# |c| < 8: 2**-4 bounds it
LSTM_TOL = 2.0**-4
# aes_merge: both sum exp in column order; the two exp implementations may
# differ in the last fp32 bits: 1e-5 of max(1, |score|)
MERGE_RTOL = 1e-5

Tensors = Dict[str, torch.Tensor]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def joint_inputs(B, K, V, J, H, seed, dev, n_dead=3, bias=False) -> Tensors:
    """Random bf16 joint weights at ``nn.Linear``'s init scale (the vocab
    product x4, peaked as a trained joint is), LayerNorm-scale encoder rows,
    tanh-range features, beam scores in [-30, 0] with the last ``n_dead``
    beams of every other utterance dead (NEG_INF); with ``bias`` an LM label
    bias with NEG_INF columns."""
    g = _gen(seed)
    uni = lambda n_in, *s: (torch.rand(*s, generator=g) * 2 - 1) / math.sqrt(n_in)
    scores = -30 * torch.rand(B, K, generator=g)
    scores[::2, K - min(n_dead, K - 1) :] = NEG
    bf = lambda x: x.to(dev, torch.bfloat16)
    f32 = lambda x: x.to(dev, torch.float32)
    out = dict(
        enc_t=bf(torch.randn(B * K, J, generator=g)),
        feat=bf(torch.tanh(torch.randn(B * K, H, generator=g))),
        scores=f32(scores),
        w_dec=bf(uni(H, J, H)).t(),  # transposed views of nn.Linear weights
        b_dec=f32(uni(H, J)),
        ln_scale=f32(1 + 0.1 * torch.randn(J, generator=g)),
        ln_bias=f32(0.1 * torch.randn(J, generator=g)),
        w_out=bf(4 * uni(J, V, J)).t(),
        b_out=f32(uni(J, V)),
    )
    if bias:
        lb = 0.5 * torch.randn(B * K, V, generator=g)
        lb[:, : V // 7] = NEG  # columns outside an LM's vocab
        out["label_bias"] = f32(lb)
    return out


def _joint_work(a: Tensors, blank: int, eos, fold: bool) -> torch.Tensor:
    """Every column's ``score + lp`` as the plain version forms it (blank and
    a folded eos at NEG_INF), to look up the value of any picked column."""
    d = a["feat"].float() @ a["w_dec"].float() + a["b_dec"]
    mu = d.mean(1, keepdim=True)
    d = (d - mu) * torch.rsqrt(((d - mu) ** 2).mean(1, keepdim=True) + dk.LN_EPS)
    h = torch.relu(a["enc_t"].float() + d * a["ln_scale"] + a["ln_bias"]).bfloat16()
    lp = torch.log_softmax(h.float() @ a["w_out"].float() + a["b_out"], 1)
    lp[:, blank] = NEG
    if fold:
        lp[:, eos] = NEG
    if "label_bias" in a:
        fused = lp + a["label_bias"]
        lp = fused + (torch.logsumexp(lp, 1, keepdim=True) - torch.logsumexp(fused, 1, keepdim=True))
    return a["scores"].reshape(-1, 1) + lp


def check_joint(a: Tensors, K, n, blank=0, eos=None, fold=False, tol=JOINT_TOL) -> float:
    """Blank log-probs, values (and factors) within ``tol``; indices equal
    wherever the plain values do not tie within ``tol``: where they differ,
    the plain value of the kernel's column must be within ``tol`` of the
    plain value at that rank. Each flat index must lie in its own row."""
    kw = dict(K=K, n_cand=n, blank=blank, eos=eos, fold_eos_into_blank=fold)
    before = dk.fused_joint_topk.launches
    got = dk.fused_joint_topk(**a, **kw)
    torch.cuda.synchronize()
    assert dk.fused_joint_topk.launches == before + 1
    want = dk.fused_joint_topk_reference(**a, **kw)
    assert len(got) == len(want)
    pairs = [(got[0], want[0]), (got[1], want[1])] + ([(got[3], want[3])] if len(got) == 4 else [])
    errs = [(g - w).abs().max().item() for g, w in pairs]
    assert all(math.isfinite(e) and e <= tol for e in errs), f"fused_joint_topk errors {errs} > {tol}"
    V, BK = a["w_out"].shape[1], a["enc_t"].shape[0]
    g_flat, w_flat = got[2].reshape(BK, n).long(), want[2].reshape(BK, n).long()
    rows = torch.arange(BK, device=g_flat.device)[:, None] % K
    assert bool(((g_flat // V) == rows).all()), "fused_joint_topk: index outside its row"
    differ = g_flat != w_flat
    if bool(differ.any()):
        picked = _joint_work(a, blank, eos, fold).gather(1, g_flat % V)
        gap = (picked - want[1].reshape(BK, n)).abs()[differ].max().item()
        assert gap <= tol, f"fused_joint_topk picked a column {gap} below the plain pick"
    return max(errs)


def lstm_inputs(B, K, H, L, seed, dev, live_frac=0.8) -> Tensors:
    """bf16 packed state (tanh-range h, unit-normal c), sources within each
    utterance's K rows, live rows drawn with probability ``live_frac`` (0:
    every row dead, 1: every row live), gate kernels at init scale."""
    g = _gen(seed)
    BK = B * K
    bf = lambda x: x.to(dev, torch.bfloat16)
    uni = lambda *s: (torch.rand(*s, generator=g) * 2 - 1) / math.sqrt(H)
    src = (torch.arange(BK) // K) * K + torch.randint(0, K, (BK,), generator=g)
    h = torch.tanh(torch.randn(BK, L * H, generator=g))
    return dict(
        x=bf(torch.randn(BK, H, generator=g)),
        S=bf(torch.cat([h, torch.randn(BK, L * H, generator=g)], 1)),
        src=src.to(dev),
        live=(torch.rand(BK, generator=g) < live_frac).to(dev),
        w_ih=bf(uni(L, 4 * H, H)).transpose(1, 2),  # transposed nn.Linear stacks
        b_ih=uni(L, 4 * H).to(dev),
        w_hh=bf(uni(L, 4 * H, H)).transpose(1, 2),
    )


def check_lstm(a: Tensors, B, K, tol=LSTM_TOL) -> float:
    """Within ``tol`` of the plain bf16 version; dead rows carry the gathered
    state bit for bit."""
    before = dk.lstm_step_reorder.launches
    got = dk.lstm_step_reorder(**a, B=B, K=K)
    torch.cuda.synchronize()
    assert dk.lstm_step_reorder.launches == before + 1
    want = dk.lstm_step_reorder_reference(**a, B=B, K=K)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    dead = ~a["live"]
    assert torch.equal(got[dead], a["S"][a["src"][dead]]), "lstm_step_reorder: dead rows changed"
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= tol, f"lstm_step_reorder error {err} > {tol}"
    return err


def merge_inputs(B, K, seed, dev, n_hash=None, blank_lp=False) -> Tensors:
    """Pool and expansion columns with dead slots (NEG_INF) and duplicate
    hashes (``n_hash`` values around 0, so that some equal a dead column's
    stand-in -(c+1)) within and across the halves. Rows that stress the
    stable order, where B allows: row 2 ties (every score equal, the
    expansions' hashes half equal to the pool's), row 3 all NEG_INF, row 4
    one live column. The expansion scores are ``blank_scores`` plus a blank
    log-prob (multiples of 1/8, so that row 2's sums tie exactly); with
    ``blank_lp`` they come apart, as ``blank_scores`` and ``blank_lp``."""
    g = _gen(seed)
    n_hash = n_hash or max(2, K // 2)
    pool = -20 * torch.rand(B, K, generator=g)
    pool[:, K - K // 3 :] = NEG
    pool[0] = NEG
    blank = -20 * torch.rand(B, K, generator=g)
    blank[1::3, : max(1, K // 4)] = NEG
    ints = lambda hi: torch.randint(0, hi, (B, K), generator=g, dtype=torch.int32)
    pool_hash, exp_hash = ints(n_hash) - n_hash // 2, ints(n_hash) - n_hash // 2
    lp = -torch.randint(0, 40, (B, K), generator=g).float() / 8
    if B > 2:
        pool[2], blank[2], lp[2] = -3.0, -2.0, -1.0
        pool_hash[2], exp_hash[2] = torch.arange(K), torch.arange(K) + K // 2
    if B > 3:
        pool[3], blank[3] = NEG, NEG
    if B > 4:
        pool[4], blank[4] = NEG, NEG
        blank[4, K // 2] = -1.5
    out = dict(
        pool_scores=pool.to(dev), blank_scores=(blank if blank_lp else blank + lp).to(dev),
        pool_hash=pool_hash.to(dev), exp_hash=exp_hash.to(dev),
        pool_ver=ints(3).to(dev), pool_slot=ints(K).to(dev),
    )
    if blank_lp:
        out["blank_lp"] = lp.to(dev)
    return out


def check_merge(a: Tensors, round_j=2) -> float:
    """Exact integer outputs; scores within MERGE_RTOL of max(1, |score|).
    With ``blank_lp`` in ``a`` the fused call must also equal, bit for bit,
    the call on the pre-added scores (a second launch)."""
    before = dk.aes_merge.launches
    got = dk.aes_merge(**a, round_j=round_j)
    torch.cuda.synchronize()
    assert dk.aes_merge.launches == before + 1
    want = dk.aes_merge_reference(**a, round_j=round_j)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32 and torch.equal(g, w), "aes_merge: integer outputs differ"
    err = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1)).max().item()
    assert err <= MERGE_RTOL, f"aes_merge score error {err} > {MERGE_RTOL}"
    if "blank_lp" in a:
        pre = {k: v for k, v in a.items() if k != "blank_lp"}
        pre["blank_scores"] = a["blank_scores"] + a["blank_lp"]
        unfused = dk.aes_merge(**pre, round_j=round_j)
        torch.cuda.synchronize()
        assert dk.aes_merge.launches == before + 2
        for g, u in zip(got, unfused):
            assert torch.equal(g.view(torch.int32), u.view(torch.int32)), (
                "aes_merge: the fused blank add differs from the pre-added call")
    return (got[0] - want[0]).abs().max().item()


def backtrace_inputs(T, B, K, n_exp, V, seed, dev) -> Tensors:
    g = _gen(seed)
    R, E = n_exp + 1, n_exp
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=g, dtype=torch.int32).to(dev)
    return dict(
        active=(torch.arange(T)[:, None] < lengths[None, :]).to(dev, torch.int32),
        fp=ri(2, T, R, B, K), msrc=ri(K, T, R, B, K),
        esrc=ri(K, T, E, B, K), etok=ri(V, T, E, B, K),
        order=torch.stack([torch.randperm(K, generator=g) for _ in range(B)]).to(dev, torch.int32),
    )


def check_backtrace(a: Tensors, n_exp) -> float:
    """Both outputs exact."""
    before = dk.aes_backtrace.launches
    got = dk.aes_backtrace(**a, n_exp=n_exp)
    torch.cuda.synchronize()
    assert dk.aes_backtrace.launches == before + 1
    want = dk.aes_backtrace_reference(**a, n_exp=n_exp)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w), "aes_backtrace: outputs differ"
    return 0.0
