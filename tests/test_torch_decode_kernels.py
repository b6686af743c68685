"""The plain versions of the port's AES decode kernels against the JAX ones.

Each of ``fused_joint_topk``, ``lstm_step_reorder``, ``aes_merge`` and
``aes_backtrace`` in ``espresso_tpu_torch/ops/decode_kernels.py`` runs its
plain version on CPU tensors; here it gets the same numpy-seeded inputs as
the Pallas kernel of ``espresso_tpu/ops/decode_kernels.py`` run in interpret
mode (or, for the fp32 LSTM step, the jnp composition the decoder uses
without the kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espresso_tpu.modules.lstm import lstm_gates as jax_lstm_gates
from espresso_tpu.ops import decode_kernels as jdk
from espresso_tpu_torch.ops import decode_kernels as dk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NEG = -1.0e9
TOL = 1e-5  # fp32 on the CPU, summed in another order by each framework


def _both(x, dtype=np.float32):
    """The same values as a jnp array and a torch tensor."""
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _bf16(x):
    """The same bf16 values in both frameworks (round to nearest even)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


@pytest.mark.parametrize(
    "V,fold,bias",
    [(256, False, False), (67, False, False), (67, True, False), (256, False, True), (67, True, True)],
)
def test_fused_joint_topk_matches_jax(V, fold, bias):
    B, K, J, H, n = 4, 4, 64, 64, 6
    rng = np.random.default_rng(V + 2 * fold + bias)
    arrays = dict(
        w_dec=rng.standard_normal((H, J)) * 0.2,
        b_dec=rng.standard_normal(J) * 0.1,
        ln_scale=1.0 + 0.1 * rng.standard_normal(J),
        ln_bias=0.1 * rng.standard_normal(J),
        w_out=rng.standard_normal((J, V)) * 0.5,
        b_out=rng.standard_normal(V) * 0.1,
    )
    jw = {k: _both(v)[0] for k, v in arrays.items()}
    tw = {k: _both(v)[1] for k, v in arrays.items()}
    enc_j, enc_t = _both(rng.standard_normal((B * K, J)))
    feat_j, feat_t = _both(rng.standard_normal((B * K, H)))
    sc = rng.standard_normal((B, K)) * 3.0
    sc[1, 2:] = NEG  # dead beams: their values tie at NEG
    sc_j, sc_t = _both(sc)
    kw = dict(K=K, n_cand=n, blank=0, eos=2, fold_eos_into_blank=fold)
    lb_j = lb_t = None
    if bias:
        lb_j, lb_t = _both(rng.standard_normal((B * K, V)) * 2.0)
    want = jdk.fused_joint_topk(
        enc_j, feat_j, sc_j, label_bias=lb_j, interpret=True, row_level=True, **kw, **jw
    )
    got = dk.fused_joint_topk(enc_t, feat_t, sc_t, label_bias=lb_t, **kw, **tw)
    assert len(got) == len(want) == (4 if bias else 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if bias:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=TOL, atol=TOL)


def test_rows_topk_keeps_lax_tie_order():
    """Many equal values: the stable sort picks the lower positions first,
    as lax.top_k does."""
    rng = np.random.default_rng(1)
    vals = rng.integers(-2, 2, size=(3, 4, 5)).astype(np.float32)
    flat = rng.integers(0, 1000, size=(3, 4, 5)).astype(np.int32)
    want_v, want_i = jdk.rows_topk(jnp.asarray(vals), jnp.asarray(flat), 7)
    got_v, got_i = dk.rows_topk(torch.from_numpy(vals), torch.from_numpy(flat), 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _lstm_inputs(rng, B, K, H, L):
    BK = B * K
    src = (np.arange(BK) // K) * K + rng.integers(0, K, size=BK)
    return dict(
        x=rng.standard_normal((BK, H)) * 0.5,
        h=rng.standard_normal((L, BK, H)) * 0.5,
        c=rng.standard_normal((L, BK, H)) * 0.5,
        src=src.astype(np.int32),
        live=rng.integers(0, 2, size=BK).astype(bool),
        w_ih=rng.standard_normal((L, H, 4 * H)) * 0.2,
        b_ih=rng.standard_normal((L, 4 * H)) * 0.1,
        w_hh=rng.standard_normal((L, H, 4 * H)) * 0.2,
    )


def test_pack_state_and_feature_match_jax():
    rng = np.random.default_rng(2)
    h_j, h_t = _both(rng.standard_normal((2, 6, 8)))
    c_j, c_t = _both(rng.standard_normal((2, 6, 8)))
    S = dk.pack_lstm_state(h_t, c_t)
    np.testing.assert_array_equal(S.numpy(), np.asarray(jdk.pack_lstm_state(h_j, c_j)))
    np.testing.assert_array_equal(dk.lstm_feat(S, 2).numpy(), np.asarray(jdk.lstm_feat(jnp.asarray(S.numpy()), 2)))
    h2, c2 = dk.unpack_lstm_state(S, 2)
    np.testing.assert_array_equal(h2.numpy(), h_t.numpy())
    np.testing.assert_array_equal(c2.numpy(), c_t.numpy())


def test_lstm_step_reorder_fp32_matches_jax_composition():
    """fp32: the decoder's jnp sequence take(state, src) -> LSTM step ->
    where(live, new, old), to fp32 accuracy."""
    B, K, H, L = 3, 4, 64, 2
    a = _lstm_inputs(np.random.default_rng(3), B, K, H, L)
    hg = jnp.take(jnp.asarray(a["h"], jnp.float32), a["src"], axis=1)
    cg = jnp.take(jnp.asarray(a["c"], jnp.float32), a["src"], axis=1)
    xl, hs, cs = jnp.asarray(a["x"], jnp.float32), [], []
    for l in range(L):
        pre = xl @ a["w_ih"][l].astype(np.float32) + a["b_ih"][l].astype(np.float32)
        pre = pre + hg[l] @ a["w_hh"][l].astype(np.float32)
        hn, cn = jax_lstm_gates(pre, hg[l], cg[l])
        hs.append(hn)
        cs.append(cn)
        xl = hn
    live = a["live"][None, :, None]
    want = jdk.pack_lstm_state(jnp.where(live, jnp.stack(hs), hg), jnp.where(live, jnp.stack(cs), cg))
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in a.items() if k not in ("src", "live")}
    got = dk.lstm_step_reorder(
        t["x"], dk.pack_lstm_state(t["h"], t["c"]), torch.from_numpy(a["src"]),
        torch.from_numpy(a["live"]), t["w_ih"], t["b_ih"], t["w_hh"], B=B, K=K,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_lstm_step_reorder_bf16_matches_jax_kernel():
    """bf16: the plain version against the Pallas kernel in interpret mode.
    Both sum pre in fp32 from bf16 products and evaluate the gates as the
    TPU kernel's bf16 op chains, each op rounded: equal but where the two
    libraries' exp differ in the last fp32 bit and a value rounds to the
    neighbouring bf16 number (one ulp, 2**-6 at |c| < 4)."""
    B, K, H, L = 2, 4, 128, 2
    a = _lstm_inputs(np.random.default_rng(4), B, K, H, L)
    j, t = {}, {}
    for k in ("x", "h", "c", "w_ih", "w_hh"):
        j[k], t[k] = _bf16(a[k])
    want = jdk.lstm_step_reorder(
        j["x"], jdk.pack_lstm_state(j["h"], j["c"]), jnp.asarray(a["src"]), jnp.asarray(a["live"]),
        j["w_ih"], jnp.asarray(a["b_ih"], jnp.float32), j["w_hh"], B=B, K=K, interpret=True,
    )
    got = dk.lstm_step_reorder(
        t["x"], dk.pack_lstm_state(t["h"], t["c"]), torch.from_numpy(a["src"]),
        torch.from_numpy(a["live"]), t["w_ih"], torch.from_numpy(a["b_ih"].astype(np.float32)),
        t["w_hh"], B=B, K=K,
    )
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert err.max() <= 2.0**-6, err.max()
    assert (err > 0).mean() <= 0.01, (err > 0).mean()


@pytest.mark.parametrize("K", [5, 20])
def test_aes_merge_matches_jax(K):
    """Dead slots and duplicate hashes across the pool and the expansions;
    K = 20 gives a 40-column pool."""
    B = 6
    rng = np.random.default_rng(K)
    pool = rng.standard_normal((B, K)).astype(np.float32)
    pool[:, K - 2 :] = NEG
    pool[0, :] = NEG  # an utterance with an empty pool
    blank = rng.standard_normal((B, K)).astype(np.float32)
    blank[2, 1] = NEG
    ints = dict(
        pool_hash=rng.integers(0, 4, (B, K)),
        exp_hash=rng.integers(0, 4, (B, K)),
        pool_ver=rng.integers(0, 2, (B, K)),
        pool_slot=rng.integers(0, K, (B, K)),
    )
    j = {k: jnp.asarray(v, jnp.int32) for k, v in ints.items()}
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in ints.items()}
    want = jdk.aes_merge(jnp.asarray(pool), jnp.asarray(blank), round_j=1, interpret=True, **j)
    got = dk.aes_merge(torch.from_numpy(pool), torch.from_numpy(blank), round_j=1, **t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("K", [4, 20])
def test_aes_merge_with_blank_lp_matches_the_pre_added_call_and_jax(K):
    """``blank_lp=x`` adds x to the expansions' scores: bit for bit the call
    on ``exp + x`` (one fp32 add, rounded once either way), and JAX's merge
    given ``exp + x``. Equal scores and hashes shared within and across the
    halves stress the stable order."""
    B = 5
    rng = np.random.default_rng(K + 100)
    pool = rng.integers(-6, 0, (B, K)).astype(np.float32)
    pool[:, K - 1] = NEG
    pool[0] = NEG
    exp = rng.integers(-6, 0, (B, K)).astype(np.float32) * np.float32(0.5)
    blank = -rng.random((B, K)).astype(np.float32)
    blank[1] = np.float32(-0.5)  # equal sums within the row
    exp[2] = NEG  # only the pool survives
    ints = dict(
        pool_hash=rng.integers(-2, 3, (B, K)), exp_hash=rng.integers(-2, 3, (B, K)),
        pool_ver=rng.integers(0, 3, (B, K)), pool_slot=rng.integers(0, K, (B, K)),
    )
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in ints.items()}
    j = {k: jnp.asarray(v, jnp.int32) for k, v in ints.items()}
    fused = dk.aes_merge(torch.from_numpy(pool), torch.from_numpy(exp), round_j=2,
                         blank_lp=torch.from_numpy(blank), **t)
    added = torch.from_numpy(exp) + torch.from_numpy(blank)
    plain = dk.aes_merge(torch.from_numpy(pool), added, round_j=2, **t)
    for f, p in zip(fused, plain):
        assert f.dtype == p.dtype and torch.equal(f, p)
    want = jdk.aes_merge(jnp.asarray(pool), jnp.asarray(added.numpy()), round_j=2,
                         interpret=True, **j)
    np.testing.assert_allclose(fused[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    for g, w in zip(fused[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_exp", [1, 2])
def test_aes_backtrace_matches_jax(n_exp):
    T, B, K, V = 9, 3, 4, 50
    R, E = n_exp + 1, n_exp
    rng = np.random.default_rng(n_exp)
    lengths = np.array([9, 6, 3])
    active = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int32)
    arrays = dict(
        fp=rng.integers(0, 2, (T, R, B, K)),
        msrc=rng.integers(0, K, (T, R, B, K)),
        esrc=rng.integers(0, K, (T, E, B, K)),
        etok=rng.integers(1, V, (T, E, B, K)),
        order=np.stack([rng.permutation(K) for _ in range(B)]),
    )
    j = {k: jnp.asarray(v, jnp.int32) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrays.items()}
    want = jdk.aes_backtrace(jnp.asarray(active)[:, :, None], n_exp=n_exp, interpret=True, **j)
    got = dk.aes_backtrace(torch.from_numpy(active), n_exp=n_exp, **t)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() > 0


def _tabulated_backtrace(active, fp, msrc, esrc, etok, order, n_exp):
    """A model of csrc/aes_backtrace.cu: each frame's step as a table over
    the K + 1 incoming columns (column K: any slot outside [0, K), whose
    gathers read 0) of the outgoing column, the exit level and the emitted
    tokens, built with no reference to any other frame; then the walk
    composes the tables frame by frame, one lookup a frame, from each
    utterance's last active frame down (past it nothing is emitted)."""
    T, R, B, K = fp.shape
    col = lambda s: torch.where((s >= 0) & (s < K), s, K).long()
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1])], 1)  # column K reads 0
    gather = lambda x, s: pad(x).gather(1, col(s))
    nxt = torch.empty((T, B, K + 1), dtype=torch.long)
    lvl = torch.empty((T, B, K + 1), dtype=torch.long)
    tok = torch.empty((T, n_exp, B, K + 1), dtype=torch.int32)
    s = torch.arange(K + 1).expand(B, K + 1)  # the incoming columns (K: outside)
    for t in range(T):
        cont = (active[t] > 0)[:, None].expand(B, K + 1)
        exit_level = torch.full((B, K + 1), -1)
        exit_slot = cur = s
        for j in range(n_exp, -1, -1):
            f = gather(fp[t, j], cur) > 0
            src = gather(msrc[t, j], cur)
            exit_level = torch.where(cont & ~f, j, exit_level)
            exit_slot = torch.where(cont & ~f, src, exit_slot)
            cur = torch.where(cont & f, src, cur)
            cont = cont & f
        s2 = exit_slot
        for r in range(n_exp, 0, -1):
            m = exit_level >= r
            tok[t, n_exp - r] = torch.where(m, gather(etok[t, r - 1], s2), 0)
            s2 = torch.where(m, gather(esrc[t, r - 1], s2), s2)
        nxt[t], lvl[t] = col(s2), exit_level
    toks = torch.empty((T, n_exp, B, K), dtype=torch.int32)
    valid = torch.empty_like(toks)
    t_used = torch.where((active > 0).any(0), (active > 0).int().cumsum(0).argmax(0) + 1, 0)
    w = col(order)  # each walker's column
    for t in range(T - 1, -1, -1):
        used = (t < t_used)[:, None]  # [B, 1]: at or before the last active frame
        toks[t] = torch.where(used, tok[t].gather(2, w[None].expand(n_exp, B, K)), 0)
        rounds = torch.arange(n_exp, 0, -1)[:, None, None]
        valid[t] = (used & (lvl[t].gather(1, w)[None] >= rounds)).to(torch.int32)
        w = torch.where(used, nxt[t].gather(1, w), w)
    return toks, valid


@pytest.mark.parametrize("T,B,K,n_exp", [(7, 3, 4, 2), (5, 2, 1, 1), (6, 3, 5, 3)])
def test_aes_backtrace_tables_composed_frame_by_frame_match_jax(T, B, K, n_exp):
    """The kernel's tabulated walk gives the JAX kernel's outputs on inputs
    with out-of-range order/msrc/esrc entries, inactive frames and slots
    that stay from-pool through every merge round."""
    from espresso_tpu_torch.ops import kernel_checks as kc

    a = kc.backtrace_inputs(T, B, K, n_exp, V=50, seed=T + K, dev="cpu", edges=True)
    outside = lambda x: ((x < 0) | (x >= K)).any().item()
    assert outside(a["order"]) and outside(a["msrc"]) and outside(a["esrc"])
    assert (a["active"] == 0).any() and (a["fp"] == 1).all(1).any()
    assert (a["active"][-1] == 0).any()  # an utterance whose last frames are inactive
    j = {k: jnp.asarray(v.numpy()) for k, v in a.items() if k != "active"}
    want = jdk.aes_backtrace(jnp.asarray(a["active"].numpy())[:, :, None], n_exp=n_exp,
                             interpret=True, **j)
    got = _tabulated_backtrace(**a, n_exp=n_exp)
    plain = dk.aes_backtrace(**a, n_exp=n_exp)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    assert got[1].sum() > 0


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    before = [f.launches for f in dk.KERNELS]
    rng = np.random.default_rng(5)
    B, K = 2, 3
    z = torch.zeros((B, K), dtype=torch.int32)
    dk.aes_merge(torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32)), z, z, z, z, 0)
    assert [f.launches for f in dk.KERNELS] == before
    with pytest.raises(ValueError, match="unsupported device"):
        dk.aes_merge(*(torch.zeros((B, K), device="meta") for _ in range(6)), 0)
