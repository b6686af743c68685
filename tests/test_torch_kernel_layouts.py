"""The one-time weight layout of the ``lstm_step_reorder`` kernel, on the
CPU: a permutation of ``beam_kernel_weights``' gate kernels, whose inverse
gives them back exactly, with the gate columns interleaved as the kernel's
epilogue reads them."""

import pytest
import torch

from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import decode_kernels as dk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's own thread
    pool in each would oversubscribe the cores (these ops are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("H,L", [(64, 1), (128, 3)])
def test_lstm_kernel_layout_is_an_invertible_permutation(H, L):
    torch.manual_seed(H + L)
    cfg = TransducerConfig(
        feat_dim=8, vocab_size=16,
        encoder=SpeechTransformerConfig(
            encoder_embed_dim=32, encoder_ffn_dim=32, encoder_layers=1, encoder_heads=2,
        ),
        pred_embed_dim=H, pred_hidden_size=H, pred_layers=L, joint_dim=32,
    )
    _, pw = TransducerModel(cfg).beam_kernel_weights()
    w_ih, w_hh = pw["w_ih"], pw["w_hh"]  # [L, H, 4H]
    wk = dk.lstm_kernel_layout(w_ih, w_hh)
    assert wk.shape == (L * 4 * H, 2 * H) and wk.is_contiguous()

    perm = dk.lstm_gate_interleave(H)
    assert torch.equal(torch.sort(perm).values, torch.arange(4 * H))
    # each 8-row group is one gate (i, f, g, o in turn) of 8 consecutive units
    rows = perm.reshape(H // 8, 4, 8)
    assert torch.equal(rows // H, torch.arange(4)[None, :, None].expand_as(rows))
    units = rows % H
    assert torch.equal(units, units[:, :1].expand_as(units))
    assert torch.equal(units[:, 0].reshape(-1), torch.arange(H))

    back = wk.reshape(L, 4 * H, 2 * H)[:, torch.argsort(perm)].transpose(1, 2)
    assert torch.equal(back[:, :H], w_ih) and torch.equal(back[:, H:], w_hh)


# ---------------------------------------------------------------------------
# rnnt_joint_bwd (B5): the tile schedule of its two persistent kernels and
# the tensor map of the output weights
# ---------------------------------------------------------------------------

from espresso_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from espresso_tpu_torch.ops import rnnt_kernels as rk  # noqa: E402


def _tma_box(storage: torch.Tensor, spec, coords):
    """What a TMA load of the box at ``coords`` (innermost first) reads from
    the bf16 tensor whose contiguous memory is ``storage``, by the tensor
    map ``spec`` ({rank, dims, strides in bytes, box}): elements outside the
    dims read zero. Returned with the innermost dimension last."""
    rank, dims, strides, box = spec[0], spec[1:4], spec[4:6], spec[6:9]
    elem = [1] + [s // storage.element_size() for s in strides[: rank - 1]]
    idx = [torch.arange(box[d]) + coords[d] for d in range(rank)]
    grids = torch.meshgrid(*reversed(idx), indexing="ij")  # outermost first
    ok = torch.ones(grids[0].shape, dtype=torch.bool)
    flat = torch.zeros(grids[0].shape, dtype=torch.long)
    for d in range(rank):
        x = grids[rank - 1 - d]
        ok &= (x >= 0) & (x < dims[d])
        flat += x.clamp(0, dims[d] - 1) * elem[d]
    return torch.where(ok, storage[flat], torch.zeros((), dtype=storage.dtype))


def _block_share(n: int, grid: int, block: int) -> range:
    """The work items of one block, as rnnt_joint_bwd.cu's kernels take
    them: [n block / grid, n (block + 1) / grid)."""
    return range(n * block // grid, n * (block + 1) // grid)


def _tile_rows(i: int, T: int, U1: int, nu: int, nt: int):
    """The lattice cells (b, t, u) of tile i in the kernels' row order
    r = 8 ul + f (tile i = (b nu + ug) nt + ts), None where the row lies
    past T or U1 (a zero row)."""
    ts, rest = i % nt, i // nt
    ug, b = rest % nu, rest // nu
    cells = []
    for r in range(rk.TILE_U * rk.TILE_T):
        t, u = ts * rk.TILE_T + r % rk.TILE_T, ug * rk.TILE_U + r // rk.TILE_T
        cells.append((b, t, u) if t < T and u < U1 else None)
    return cells


@pytest.mark.parametrize(
    "B,T,U1,V,n_sm",
    [(2, 37, 9, 5003, 132), (1, 1, 1, 67, 132), (3, 20, 17, 200, 7), (4, 16, 8, 1024, 5)],
)
def test_joint_bwd_schedule_covers_every_lattice_row_once(B, T, U1, V, n_sm):
    s = rk.joint_bwd_schedule(B, T, U1, V, n_sm)
    assert s["tiles"] == B * s["nu"] * s["nt"] and s["nu"] * 8 >= U1 and s["nt"] * 8 >= T
    for n, grid in ((s["tiles"], s["grid_rows"]), (s["units"], s["grid_cols"])):
        assert 1 <= grid <= n_sm
        shares = [_block_share(n, grid, k) for k in range(grid)]
        assert [i for sh in shares for i in sh] == list(range(n))  # contiguous, in order, once
    seen = {}
    for i in range(s["tiles"]):
        cells = _tile_rows(i, T, U1, s["nu"], s["nt"])
        assert len(cells) == 64
        for r, c in enumerate(cells):
            if c is not None:
                assert c not in seen, (c, seen.get(c), (i, r))
                seen[c] = (i, r)
    assert sorted(seen) == [(b, t, u) for b in range(B) for t in range(T) for u in range(U1)]
    # a unit is (V tile, tile), V tile slowest: every (V tile, lattice row) once
    nv = -(-V // 64)
    assert s["units"] == nv * s["tiles"]


def test_joint_bwd_schedule_at_the_flagship_fills_the_card():
    s = rk.joint_bwd_schedule(16, 256, 101, 1024, 132)
    assert (s["nu"], s["nt"], s["tiles"]) == (13, 32, 6656)
    assert s["grid_rows"] == s["grid_cols"] == 132
    sizes = {len(_block_share(s["tiles"], 132, k)) for k in range(132)}
    assert sizes == {50, 51}  # every SM gets 50 or 51 tiles


@pytest.mark.parametrize("J,V", [(512, 1024), (128, 67), (256, 5003)])
def test_joint_bwd_weight_tiles_reassemble_the_weight(J, V):
    torch.manual_seed(V)
    w = torch.randn(V, J).to(torch.bfloat16)  # the nn.Linear layout, contiguous
    spec = rk.joint_bwd_tmap_spec(J, V)
    assert spec[6] * 2 == 128 and spec[4] % 16 == 0  # 128-byte rows of the swizzle, aligned strides
    nv = -(-V // 64)
    tiles = torch.stack([
        torch.cat([_tma_box(w.reshape(-1), spec, (kb * 64, vt * 64)) for kb in range(J // 64)], 1)
        for vt in range(nv)
    ])  # [V tiles, 64, J]
    assert torch.equal(tiles.reshape(-1, J)[:V], w)
    assert not tiles.reshape(-1, J)[V:].any()  # rows past V read zeros


# ---------------------------------------------------------------------------
# rel_attention_train backward (B3): the tensor maps of its TMA tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T,H", [(3, 37, 2), (2, 64, 1), (1, 1, 3), (2, 130, 2)])
def test_train_bwd_tmap_boxes_stay_in_one_utterance_and_head(B, T, H):
    D = H * ak.HEAD_DIM
    torch.manual_seed(T)
    x = torch.randn(B, T, D).to(torch.bfloat16)
    p = torch.randn(2 * T - 1, D).to(torch.bfloat16)
    specs = ak.train_bwd_tmap_specs(B, T, D)
    assert len(specs) == 6
    for spec in specs:
        assert spec[6] * 2 == 128 and all(s % 16 == 0 for s in spec[4:4 + spec[0] - 1])
    nt = -(-T // 64)
    for spec in specs[:5]:  # q_u, q_v, k, v, g: one head x 64 positions x one utterance
        for b in range(B):
            for h in range(H):
                box = torch.cat([_tma_box(x.reshape(-1), spec, (h * 64, t * 64, b)) for t in range(nt)], 1)
                assert box.shape == (1, nt * 64, 64)
                assert torch.equal(box[0, :T], x[b, :, h * 64:(h + 1) * 64])
                assert not box[0, T:].any()  # zeros past T, not the next utterance
    # p: windows of 128 relative positions, j0 = T - 1 + k0 - q0 - 63 may lie
    # before the table or past its end; positions outside [0, 2T - 1) read zeros
    for h in range(H):
        for j0 in (T - 1 - (nt - 1) * 64 - 63, -63, 0, T - 1, 2 * T - 2):
            rows = torch.cat([_tma_box(p.reshape(-1), specs[5], (h * 64, j0 + 64 * i)) for i in range(2)])
            j = torch.arange(j0, j0 + 128)
            ok = (j >= 0) & (j < 2 * T - 1)
            ref = torch.zeros(128, 64, dtype=p.dtype)
            ref[ok] = p[j[ok], h * 64:(h + 1) * 64]
            assert torch.equal(rows, ref)


# ---------------------------------------------------------------------------
# rel_attention (B1): its tiles, the skew of its bd window and its shared
# memory; rnnt_joint_lp (B4): its units of two of the backward's tiles and
# its V tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 156, 200, 1024, 1344])
def test_rel_attention_tiles_cover_every_score_once(T):
    """Each block owns query rows [q0, q0 + 64) and walks key tiles k0 = 64 kt
    (rel_attention.cu); the bd of (query q0 + r, key k0 + c) is read from
    window row c - r + 63 of the p rows [j0, j0 + 128), j0 = T - 1 + k0 - q0
    - 63: every (query, key) pair is met once, at the p row of its relative
    position T - 1 + k - q, inside the window."""
    nt = -(-T // 64)
    seen = torch.zeros(T, T, dtype=torch.int64)
    r = torch.arange(64)[:, None]
    c = torch.arange(64)[None, :]
    for qt in range(nt):
        for kt in range(nt):
            q0, k0 = 64 * qt, 64 * kt
            j0 = T - 1 + k0 - q0 - 63
            jp = c - r + 63
            assert int(jp.min()) >= 0 and int(jp.max()) + 1 < 128  # jp and jp + 1 in the window
            q, k = q0 + r, k0 + c
            assert torch.equal(j0 + jp, T - 1 + k - q)
            qs, ks = q[:, 0][q[:, 0] < T], k[0][k[0] < T]
            seen[qs[:, None], ks[None, :]] += 1
    assert torch.equal(seen, torch.ones(T, T, dtype=torch.int64))


def test_rel_attention_shared_memory_limits_its_length():
    # the flagship's blocks fit three an SM (228 KB, 1 KB of it reserved a
    # block); the longest T whose score rows fit takes one block, and past
    # it the long-row mode runs, two blocks an SM up to the wrapper's limit
    assert 3 * (ak.rel_attention_smem_bytes(156) + 1024) <= 228 * 1024
    short = ak.REL_ATTENTION_SHORT_MAX_T
    assert ak.rel_attention_smem_bytes(short) <= ak.SMEM_LIMIT
    assert ak._fwd_smem_bytes(short + 1, 2) > ak.SMEM_LIMIT
    assert short == 1344 and not ak.rel_attention_long_rows(short)
    assert ak.rel_attention_long_rows(short + 1)
    assert ak.rel_attention_smem_bytes(short + 1) == ak.long_rows_smem_bytes(short + 1)
    assert ak.REL_ATTENTION_MAX_T == 4096
    assert 2 * (ak.rel_attention_smem_bytes(ak.REL_ATTENTION_MAX_T) + 1024) <= 228 * 1024
    # up to two key tiles the scores stay in registers: no shared score rows
    assert ak.rel_attention_smem_bytes(128) - ak.rel_attention_smem_bytes(64) == 4 * 64


@pytest.mark.parametrize(
    "B,T,U1,V,n_sm",
    [(2, 37, 9, 5003, 132), (1, 1, 1, 67, 132), (3, 17, 5, 1024, 7), (16, 256, 101, 1024, 132)],
)
def test_joint_lp_units_cover_every_lattice_row_and_column_once(B, T, U1, V, n_sm):
    """rnnt_joint_lp.cu's schedule: the backward's tiles in their order,
    unit k = tiles 2k (first warpgroup) and 2k + 1 (second; none past the
    last tile), blocks min(units, SMs) with contiguous shares; V tiles of
    128 columns padded to an even count, a tile past V reloading the last."""
    s = rk.joint_bwd_schedule(B, T, U1, V, n_sm)
    units = -(-s["tiles"] // 2)
    grid = min(units, n_sm)
    shares = [_block_share(units, grid, k) for k in range(grid)]
    assert [i for sh in shares for i in sh] == list(range(units))
    seen = {}
    for un in range(units):
        for w in range(2):
            i = 2 * un + w
            if i >= s["tiles"]:
                assert i == s["tiles"] and s["tiles"] % 2 == 1  # only the last unit's second
                continue
            for r, c in enumerate(_tile_rows(i, T, U1, s["nu"], s["nt"])):
                if c is not None:
                    assert c not in seen
                    seen[c] = (un, w, r)
    assert sorted(seen) == [(b, t, u) for b in range(B) for t in range(T) for u in range(U1)]
    nv, vlast = 2 * -(-V // 256), (V - 1) // 128
    cols = [v for vt in range(nv) for v in range(128 * min(vt, vlast), 128 * min(vt, vlast) + 128)
            if v < V and vt <= vlast]
    assert nv % 2 == 0 and sorted(cols) == list(range(V))


# ---------------------------------------------------------------------------
# the rel_attention_train forward (B2): the block of rel_attention_fwd.cuh
# with the scores and the e of three key tiles in registers, its
# dropout applied where the A fragments of the PV product are formed, and
# its shared memory
# ---------------------------------------------------------------------------

FWD_NR, FWD_NE, FWD_VG = 3, 3, 3  # rel_attention_train.cu's FWD_NR, FWD_NE; the header's VG


def _pv_fragments():
    """Every element of the PV product's A fragments in a block, as
    (warp, g, q, kk, r, e) with its row 16 warp + g + 8 (r & 1) and column
    16 kk + 8 (r >> 1) + 2 q + e in the [64 q][64 k] tile, and the index
    8 kk + 2 r + e of the lane's accumulator element it is formed from."""
    grid = torch.meshgrid(*(torch.arange(n) for n in (4, 8, 4, 4, 4, 2)), indexing="ij")
    w, g, q, kk, r, e = (x.reshape(-1) for x in grid)
    return dict(w=w, g=g, q=q, row=16 * w + g + 8 * (r & 1), col=16 * kk + 8 * (r >> 1) + 2 * q + e,
                kk=kk, hh=r & 1, acc=8 * kk + 2 * r + e)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 192, 193, 256, ak.REL_ATTENTION_TRAIN_SHORT_MAX_T])
def test_rel_attention_train_fwd_tiles_cover_every_score_and_weight_once(T):
    """Scores: query tile q0 = 64 qt, key tile k0 = 64 kt, the bd of (q0 + r,
    k0 + c) from window row c - r + 63 of p rows j0 = T - 1 + k0 - q0 - 63;
    tiles kt < FWD_NR keep s in registers, later ones in shared columns
    64 (kt - FWD_NR) + c of rows 64 wide past FWD_NR tiles (stride LDT).
    Weights: V tile kt in box kt % 3 of ring load nk + kt // 3; the A
    fragment element of (row, column) is formed from the lane's accumulator
    element of that same (row, column) (x[4 j + 2 hh + e]: row 16 warp + g +
    8 hh, column 8 j + 2 q + e), from registers for kt < FWD_NE and from the
    shared columns past it; the k16 steps past T are not run. Every (query,
    key) pair is met once in each phase."""
    nt = -(-T // 64)
    Tp = 64 * nt
    LDT = Tp - 64 * FWD_NR + 8 if Tp > 64 * FWD_NR else 0
    f = _pv_fragments()
    # the accumulator element acc holds row 16 w + g + 8 hh, column 8 j + 2 q + e
    j, hh, e = f["acc"] // 4, (f["acc"] // 2) % 2, f["acc"] % 2
    assert torch.equal(16 * f["w"] + f["g"] + 8 * hh, f["row"])
    assert torch.equal(8 * j + 2 * f["q"] + e, f["col"])
    scores = torch.zeros(T, T, dtype=torch.int64)
    weights = torch.zeros(T, T, dtype=torch.int64)
    r = torch.arange(64)[:, None]
    c = torch.arange(64)[None, :]
    loads = set()
    for qt in range(nt):
        for kt in range(nt):
            q0, k0 = 64 * qt, 64 * kt
            j0 = T - 1 + k0 - q0 - 63
            jp = c - r + 63
            assert int(jp.min()) >= 0 and int(jp.max()) + 1 < 128
            assert torch.equal(j0 + jp, T - 1 + (k0 + c) - (q0 + r))
            if kt >= FWD_NR:  # the shared score columns of this tile lie inside the row
                assert 64 * (kt - FWD_NR) + 64 <= LDT - 8
            qs, ks = (q0 + r)[:, 0], (k0 + c)[0]
            scores[qs[qs < T][:, None], ks[ks < T][None, :]] += 1
            run = k0 + 16 * f["kk"] < T
            if kt >= FWD_NE:
                assert kt >= FWD_NR  # formed again from the shared scores
            loads.add((nt + kt // FWD_VG, kt % FWD_VG))
            q, k = q0 + f["row"], k0 + f["col"]
            ok = run & (q < T) & (k < T)
            weights[q[ok], k[ok]] += 1
            assert not ((k < T) & ~run).any()  # no key in range is skipped
    ones = torch.ones(T, T, dtype=torch.int64)
    assert torch.equal(scores, ones) and torch.equal(weights, ones)
    n_loads = nt + -(-nt // FWD_VG)
    assert sorted(loads) == [(it, i) for it in range(nt, n_loads) for i in range(FWD_VG)
                             if FWD_VG * (it - nt) + i < nt]


@pytest.mark.parametrize("T,q0,b,h", [(256, 64, 5, 7), (70, 0, 0, 0), (193, 192, 15, 3)])
def test_rel_attention_train_fwd_keep_factor_is_the_dropout_mask(T, q0, b, h):
    """The keep factor each lane forms for its fragment element equals
    dropout_keep_mask. The kernel's KeepHook: the row hash states h =
    imix(imix(seed + b GOLD + h HEAD_MUL) + row GOLD) of rows q0 + 16 warp + g
    and + 8 (row_hashes), formed once as h ^ (h >> 16); for key k, km = k
    KEY_MUL and x = that ^ km ^ (km >> 16) (imix's first xor-shift of h ^ km,
    split), then imix's last four steps, kept when x < 2 threshold (the
    31-bit draw x >> 1 below the threshold)."""
    seed, rate = 123456789, 0.1
    f = _pv_fragments()
    m32 = lambda x: x & 0xFFFFFFFF
    base = ak._imix(m32(torch.tensor(seed) + ak._mul32(torch.tensor(b), ak._GOLD)
                        + ak._mul32(torch.tensor(h), ak._HEAD_MUL)))
    row_state = [ak._imix(m32(base + ak._mul32(q0 + 16 * f["w"] + f["g"] + 8 * hh, ak._GOLD)))
                 for hh in range(2)]
    state = torch.where(f["hh"] == 1, row_state[1], row_state[0])
    hs = state ^ (state >> 16)
    want = ak.dropout_keep_mask(seed, b, h, T, T, rate)
    for k0 in range(0, T, 64):
        k = k0 + f["col"]
        km = ak._mul32(k, ak._KEY_MUL)
        x = ak._mul32(hs ^ km ^ (km >> 16), 0x85EBCA6B)
        x = ak._mul32(x ^ (x >> 13), 0xC2B2AE35)
        x = x ^ (x >> 16)
        q = q0 + f["row"]
        ok = (q < T) & (k < T)
        assert ok.any()
        assert torch.equal(x[ok] < 2 * ak.keep_threshold(rate), want[q[ok], k[ok]])


def test_rel_attention_train_fwd_shared_memory_limits_its_length():
    # two blocks an SM at the flagship train length (228 KB, 1 KB of it
    # reserved a block); one block at the longest T the kernel takes, which
    # is at least the longest the inference kernel takes
    assert 2 * (ak.rel_attention_train_smem_bytes(256) + 1024) <= 228 * 1024
    short = ak.REL_ATTENTION_TRAIN_SHORT_MAX_T
    assert ak.rel_attention_train_smem_bytes(short) <= ak.SMEM_LIMIT
    assert ak._fwd_smem_bytes(short + 1, 3) > ak.SMEM_LIMIT
    assert short == 1408 >= ak.REL_ATTENTION_SHORT_MAX_T
    assert ak.rel_attention_train_long_rows(short + 1)
    assert not ak.rel_attention_train_long_rows(short)
    # the long-row mode: two blocks an SM up to the limit of both wrappers
    assert ak.REL_ATTENTION_TRAIN_MAX_T == ak.REL_ATTENTION_MAX_T == 4096
    assert 2 * (ak.rel_attention_train_smem_bytes(4096) + 1024) <= 228 * 1024
    # up to three key tiles the scores stay in registers: no shared score rows
    assert ak.rel_attention_train_smem_bytes(192) - ak.rel_attention_train_smem_bytes(64) == 4 * 128


# ---------------------------------------------------------------------------
# the long-row mode of rel_attention_fwd.cuh (B1 past T' = 1344, B2 past
# 1408): two passes over the key tiles through a ring of {K, p window, V}
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1345, 1409, 1500, 2048, 4096])
def test_long_rows_tiles_cover_every_score_once_in_each_pass(T):
    """Ring load it (it < 2 nk) brings key tile it % nk's K and p window
    rows [j0, j0 + 128), j0 = T - 1 + k0 - q0 - 63 (and in pass 2, it >= nk,
    its V tile) into stage it % 2, whose phase is it // 2; pass 1 reads
    every (query, key) score once for the row statistics, pass 2 once more
    for the weights, whose A fragment elements (row, column) come from the
    lane's x of that same (row, column); the bd window (64 rows of 136 bf16)
    lies over the stage's K and p window and leaves its V tile alone."""
    nt = -(-T // 64)
    f = _pv_fragments()
    assert 64 * (2 * 64 + 8) * 2 <= 3 * 8192  # the window below the V tile
    r = torch.arange(64)[:, None]
    c = torch.arange(64)[None, :]
    for qt in sorted({0, 1, nt // 2, nt - 1}):
        q0 = 64 * qt
        seen = torch.zeros(2, 64, 64 * nt, dtype=torch.int64)
        phases = {0: [], 1: []}
        for it in range(2 * nt):
            kt, pas = it % nt, it // nt
            phases[it % 2].append(it // 2)
            k0 = 64 * kt
            j0 = T - 1 + k0 - q0 - 63
            jp = c - r + 63
            assert int(jp.min()) >= 0 and int(jp.max()) + 1 < 128
            assert torch.equal(j0 + jp, T - 1 + (k0 + c) - (q0 + r))
            if pas == 0:
                seen[0, :, k0:k0 + 64] += 1
            else:
                run = k0 + 16 * f["kk"] < T
                k = k0 + f["col"]
                assert not ((k < T) & ~run).any()
                seen[1, f["row"][run], k[run]] += 1
        for slot in (0, 1):
            assert phases[slot] == list(range(len(phases[slot])))
        q_in = (q0 + torch.arange(64)) < T
        for pas in (0, 1):
            assert torch.equal(seen[pas][q_in][:, :T], torch.ones(int(q_in.sum()), T, dtype=torch.int64))


def test_long_rows_online_softmax_matches_the_full_row():
    """Pass 1's statistics: each lane folds its 16 scores a tile into (m, z)
    with one rescale (z = z exp(m - m') + sum exp(x - m')), the four lanes
    of a row combine theirs (M = max, Z = sum z exp(m - M)); 1 / Z is within
    a few f32 ulps of the full row's and w = bf16(exp(x - M) / Z) is the
    plain version's up to one bf16 rounding."""
    rng = np.random.default_rng(0)
    T = 2000
    x = (rng.standard_normal(T) * 8).astype(np.float32)
    x[rng.random(T) < 0.1] = -1e8  # masked keys
    xp = np.full(64 * -(-T // 64), -np.inf, np.float32)
    xp[:T] = x
    lanes = []
    for q in range(4):  # lane q holds columns 8 j + 2 q + e of every tile
        m, z = np.float32(-np.inf), np.float32(0)
        for kt in range(len(xp) // 64):
            cols = [64 * kt + 8 * j + 2 * q + e for j in range(8) for e in range(2)]
            mt = max(m, xp[cols].max())
            ref = np.float32(0) if mt == -np.inf else mt
            z = np.float32(z * np.exp(np.float32(m - ref)) + np.exp(xp[cols] - ref).sum(dtype=np.float32))
            m = mt
        lanes.append((m, z))
    M = max(m for m, _ in lanes)
    Z = np.float32(sum(np.float32(z * np.exp(np.float32(m - M))) for m, z in lanes))
    full = np.exp(x - x.max()).sum(dtype=np.float64)
    assert M == x.max()
    assert abs(float(Z) - full) <= 8 * np.spacing(np.float32(full))
    w = torch.from_numpy(np.exp(x - M) * (np.float32(1) / Z)).to(torch.bfloat16).float()
    want = torch.softmax(torch.from_numpy(x), -1).to(torch.bfloat16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    assert bool(((w - want).abs() <= ulp).all())


# ---------------------------------------------------------------------------
# fbank (B10): the real FFT's schedule (fbank.cu) modelled in numpy from the
# wrapper's own twiddle table, its shared-memory maps, and the packed mel
# banks
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from espresso_tpu_torch.features import fbank_kernels as fk  # noqa: E402
from espresso_tpu_torch.ops import front_kernel_checks as fc  # noqa: E402

LANES = np.arange(32)
ROW = 36  # fbank.cu: the first transpose's rows of 32 points, padded


def _swz(k1, l1, k2a):
    """fbank.cu's second transpose: U(k1, l1, k2a)'s slot."""
    return 32 * k2a + 4 * k1 + (l1 ^ ((k1 >> 1) & 3))


def _mul_mi(a):
    return a.imag - 1j * a.real


def _dft4(u0, u1, u2, u3):
    """fbank.cu's dft4, op for op."""
    p0, p1, q0, q1 = u0 + u2, u0 - u2, u1 + u3, _mul_mi(u1 - u3)
    return [p0 + q0, p1 + q1, p0 - q0, p1 - q1]


def _dft8(a):
    """fbank.cu's dft8, op for op: sums and differences times w8^j, then
    4-point DFTs of each half, interleaved."""
    r = 0.70710678118654752440
    s = [a[j] + a[j + 4] for j in range(4)]
    d = [a[j] - a[j + 4] for j in range(4)]
    d[1] = r * (d[1].real + d[1].imag) + 1j * r * (d[1].imag - d[1].real)
    d[2] = _mul_mi(d[2])
    d[3] = r * (d[3].imag - d[3].real) - 1j * r * (d[3].real + d[3].imag)
    s, d = _dft4(*s), _dft4(*d)
    return [s[m // 2] if m % 2 == 0 else d[m // 2] for m in range(8)]


def _fft_power_model(y: np.ndarray, late=np.complex128) -> np.ndarray:
    """|X[k]|^2 for k < 256 of the real frames y [F, 512] (f32), computed
    as fbank.cu computes it, lanes and shared-memory slots included:
    z[n] = y[2n] + i y[2n+1] on lane n % 32; stage 1 in complex64 (an
    8-point DFT over j, w256^(lane k1) in f32) into rows of ROW points;
    then complex128: stage 2 (over l2, w32^(l1 k2a)), the swizzled
    transpose, stage 3 (4-point DFTs over l1), and the split of Z into X
    with each lane's mirror points from its partner lane; |X|^2 rounded to
    f32. Every bin is written once (a bin left NaN fails the tests).
    ``late=np.complex64`` models an FFT in f32 throughout."""
    tw1, tw23 = fk.fft_twiddles()
    w1 = (tw1[:, 0] + 1j * tw1[:, 1]).astype(np.complex64)
    w23 = (tw23[:, 0] + 1j * tw23[:, 1]).astype(late)
    F = y.shape[0]
    z = (y[:, 0::2] + 1j * y[:, 1::2]).astype(np.complex64)
    buf = np.zeros((F, 8 * ROW), late)
    a = _dft8([z[:, LANES + 32 * j] for j in range(8)])
    for k1 in range(8):
        buf[:, k1 * ROW + LANES] = a[k1] * w1[32 * k1 + LANES] if k1 else a[0]
    k1s, l1s = LANES >> 2, LANES & 3
    a = _dft8([buf[:, k1s * ROW + l1s + 4 * l2] for l2 in range(8)])
    for k2a in range(8):
        buf[:, _swz(k1s, l1s, k2a)] = a[k2a] * w23[4 * k2a + l1s] if k2a else a[0]
    # stage 3 leaves Z[lane + 32 i] on each lane (i = r + 2 k2b)
    zi = [None] * 8
    for r in range(2):
        e = _dft4(*[buf[:, _swz(LANES & 7, l1, (LANES >> 3) + 4 * r)] for l1 in range(4)])
        for k2b in range(4):
            zi[r + 2 * k2b] = e[k2b]
    # the split: lane l pairs Z[l + 32 i] (i < 4) with lane (32 - l) % 32's
    # Z[.. + 32 (7 - i)], lane 0 with its own Z[32 (8 - i) % 256]
    partner = (32 - LANES) % 32
    quarter = np.float32(0.25)
    P = np.full((F, fk.FFT_POINTS), np.nan, np.float32)
    for i in range(4):
        k = LANES + 32 * i
        za = zi[i]
        zb = zi[7 - i][:, partner]
        zb[:, 0] = zi[(8 - i) % 8][:, 0] if i else zi[0][:, 0]
        e2 = (za.real + zb.real) + 1j * (za.imag - zb.imag)  # 2E
        o2 = (za.imag + zb.imag) + 1j * (zb.real - za.real)  # 2O
        t = o2 * w23[fk.TW3 + k]
        P[:, k] = quarter * (np.abs(e2 + t) ** 2).astype(np.float32)
        mirror = k != 0
        P[:, fk.FFT_POINTS - k[mirror]] = quarter * (np.abs(e2 - t) ** 2).astype(np.float32)[:, mirror]
    P[:, fk.FFT_POINTS // 2] = np.abs(zi[4][:, 0]) ** 2  # X[128] = Z*[128], on lane 0
    return P


def _windowed_frames(wave: np.ndarray, n_frames: int, W: int = 400, shift: int = 160,
                     nfft: int = fk.FFT_SIZE) -> np.ndarray:
    """The plain version's frames before the DFT: DC removed, pre-emphasis,
    the povey window, zero-padded to nfft (f32)."""
    x = np.stack([wave[t * shift : t * shift + W] for t in range(n_frames)]).astype(np.float32)
    x = x - x.mean(1, keepdims=True)
    prev = np.concatenate([x[:, :1], x[:, :-1]], 1)
    y = (x - np.float32(fk.PREEMPHASIS) * prev) * fk.povey_window(W)
    return np.pad(y, ((0, 0), (0, nfft - W))).astype(np.float32)


def _mel_schedule_model(P, weights, meta, lens, M):
    """fbank.cu's mel product: round r's lane sums P[k0 + i] * w for its
    L_r steps, in f32, and writes its bin."""
    mel = np.full((P.shape[0], M), np.nan, np.float32)
    row = 0
    for r, L in enumerate(lens):
        for lane in range(32):
            m, k0 = meta[r, lane] >> 16, meta[r, lane] & 0xFFFF
            acc = np.zeros(P.shape[0], np.float32)
            for i in range(L):
                acc = acc + P[:, k0 + i] * weights[row + i, lane]
            if m >= 0:
                mel[:, m] = acc
        row += L
    return mel


def test_fbank_fft_schedule_reproduces_the_real_dft():
    wave = fc.waveform_inputs([16400], 16400, seed=3, dev="cpu")["waveforms"][0].numpy()
    y = _windowed_frames(wave, 100)
    P = _fft_power_model(y).astype(np.float64)
    ref = np.abs(np.fft.rfft(y.astype(np.float64), axis=1)[:, : fk.FFT_POINTS]) ** 2
    # stage 1 in f32 leaves an error floor of ~1e-7 of the frame's peak
    # energy in every bin (an all-f32 FFT's floor is ~20x that, which bins
    # 60-70 dB down cannot take); stages 2-3 and the split in f64 add
    # nothing to it
    assert (ref.min(1) < 1e-6 * ref.max(1)).any()  # bins 60 dB and more down
    err = np.abs(P - ref) / ref.max(1, keepdims=True)
    assert err.max() < 2e-7, err.max()
    # an impulse and a pure tone at a bin give their exact spectra
    imp = np.zeros((1, fk.FFT_SIZE), np.float32)
    imp[0, 3] = 1.0
    np.testing.assert_allclose(_fft_power_model(imp)[0], np.ones(fk.FFT_POINTS), rtol=1e-6)
    tone = np.cos(2 * np.pi * 37 * np.arange(fk.FFT_SIZE) / fk.FFT_SIZE).astype(np.float32)[None]
    p = _fft_power_model(tone)[0]
    assert abs(p[37] / 256.0**2 - 1) < 1e-6 and np.delete(p, 37).max() < 1e-6 * 256.0**2


def test_fbank_fft_schedule_through_the_mel_banks_matches_the_plain_version():
    """The model's power spectrum through the packed mel banks, summed over
    each bin's range as the kernel sums, against fbank_plain by the
    goldens' rule (FBANK_LOG_TOL on bins within 70 dB of the frame's peak,
    FBANK_LIN_TOL of its peak energy)."""
    S = 16400
    a = fc.waveform_inputs([S], S, seed=4, dev="cpu")
    ref, lengths = fk.fbank_plain(a["waveforms"], a["num_samples"])
    n = int(lengths[0])
    P = _fft_power_model(_windowed_frames(a["waveforms"][0].numpy(), n))
    tab = fk._kernel_tables(torch.device("cpu"), 400, 80, 16000.0)
    mel = _mel_schedule_model(P, tab["mel_w"].numpy(), tab["mel_meta"].numpy(),
                              tab["mel_len"].numpy(), 80)
    got = np.log(np.maximum(mel, np.float32(1.1920928955078125e-07))).astype(np.float64)
    want = ref[0, :n].double().numpy()
    loud = want - want.max(1, keepdims=True) >= -fc.DB70
    assert np.abs(got - want)[loud].max() < fc.FBANK_LOG_TOL
    lin = np.abs(np.exp(got) - np.exp(want)) / np.exp(want).max(1, keepdims=True)
    assert lin.max() < fc.FBANK_LIN_TOL


def test_fbank_256_point_dft_is_the_512_point_schedules_even_bins():
    """At 8 kHz (window 200, shift 80) the kernel runs its 512-point FFT on
    the frame zero-padded to 512: X512[2 k] = X256[k] exactly, so its even
    bins are the 256-point power spectrum, with the 512-point error floor
    (under 2e-7 of the frame's peak energy)."""
    wave = fc.waveform_inputs([8200], 8200, seed=5, dev="cpu", sample_rate=8000.0)
    y = _windowed_frames(wave["waveforms"][0].numpy(), 100, W=200, shift=80)
    assert not y[:, 256:].any()
    P = _fft_power_model(y).astype(np.float64)
    ref = np.abs(np.fft.rfft(y[:, :256].astype(np.float64), axis=1)) ** 2  # [F, 129]
    err = np.abs(P[:, 0::2] - ref[:, :128]) / ref.max(1, keepdims=True)
    assert err.max() < 2e-7, err.max()


def test_fbank_8khz_mel_schedule_through_the_model_matches_the_plain_version():
    """8 kHz, 80 mel bins: 14 bins take a single DFT bin and none is empty;
    the kernel's banks hold each 256-point row at its even bin, the schedule
    gives them back, and the model's spectrum through it matches fbank_plain
    by the goldens' rule."""
    _, _, mel_t = fk._dft_mel_matrices(200, 256, 80, 8000.0)
    nz = (mel_t[:128] != 0).sum(0)
    assert not mel_t[128].any() and nz.min() >= 1 and int((nz == 1).sum()) == 14
    banks = fk.kernel_mel_banks(200, 256, 80, 8000.0)
    assert banks.shape == (fk.FFT_POINTS, 80)
    np.testing.assert_array_equal(banks[0::2], mel_t[:128])
    assert not banks[1::2].any()
    w, meta, lens = fk.mel_schedule(banks)
    tab = fk._kernel_tables(torch.device("cpu"), 200, 80, 8000.0)
    np.testing.assert_array_equal(tab["mel_w"].numpy(), w)
    np.testing.assert_array_equal(tab["mel_meta"].numpy(), meta)
    S = 8200
    a = fc.waveform_inputs([S], S, seed=6, dev="cpu", sample_rate=8000.0)
    ref, lengths = fk.fbank_plain(a["waveforms"], a["num_samples"], 8000.0)
    n = int(lengths[0])
    assert n == 1 + (S - 200) // 80
    P = _fft_power_model(_windowed_frames(a["waveforms"][0].numpy(), n, W=200, shift=80))
    mel = _mel_schedule_model(P, w, meta, lens, 80)
    got = np.log(np.maximum(mel, np.float32(1.1920928955078125e-07))).astype(np.float64)
    want = ref[0, :n].double().numpy()
    loud = want - want.max(1, keepdims=True) >= -fc.DB70
    assert np.abs(got - want)[loud].max() < fc.FBANK_LOG_TOL
    lin = np.abs(np.exp(got) - np.exp(want)) / np.exp(want).max(1, keepdims=True)
    assert lin.max() < fc.FBANK_LIN_TOL


def _mel_log_errors(late, n_utts=24):
    """The worst log error of the model's mel bins within 70 dB of their
    frame's peak, against float64, over utterances like the card tests'
    (two tones over int16-scale noise)."""
    wav = fc.waveform_inputs([16400] * n_utts, 16400, seed=0, dev="cpu")["waveforms"].numpy()
    banks = fk._dft_mel_matrices(400, 512, 80, 16000.0)[2][: fk.FFT_POINTS].astype(np.float64)
    worst = 0.0
    for b in range(n_utts):
        y = _windowed_frames(wav[b], 100)
        exact = np.abs(np.fft.rfft(y.astype(np.float64), axis=1)[:, : fk.FFT_POINTS]) ** 2
        want = np.log(np.maximum(exact @ banks, 1.1920928955078125e-07))
        got = np.log(np.maximum(_fft_power_model(y, late).astype(np.float64) @ banks,
                                1.1920928955078125e-07))
        loud = want - want.max(1, keepdims=True) >= -fc.DB70
        worst = max(worst, float(np.abs(got - want)[loud].max()))
    return worst


def test_fbank_fft_in_f64_after_stage_1_keeps_the_quiet_bins():
    """Why stages 2-3 and the split run in f64: an FFT's rounding leaves an
    error floor that is a share of the frame's peak in every bin, and the
    split pairs bin k with bin 256 - k, where pre-emphasis makes the low
    bins the quietest and their mirrors the loudest. In f32 throughout the
    mel bins 60-70 dB down lose about half of FBANK_LOG_TOL (2.3e-4 on
    these inputs) before the plain version's own error is added; with f64
    after stage 1, about a fifth (1.1e-4)."""
    f32, mixed = _mel_log_errors(np.complex64), _mel_log_errors(np.complex128)
    assert mixed < 1.2e-4 and f32 > 2e-4, (mixed, f32)


def test_fbank_fft_shared_memory_maps_are_conflict_free_bijections():
    """Each shared-memory step of a frame's FFT (fbank.cu) is free of bank
    conflicts: the first transpose's 8-byte points hit 16 distinct slots
    mod 128 bytes a half-warp, the second's 16-byte points 8 a
    quarter-warp; each transpose's writes and reads meet the same slots."""
    def half_warps_distinct(slots):
        slots = np.asarray(slots) % 16
        return all(len(set(slots[h * 16 : h * 16 + 16])) == 16 for h in range(2))

    def quarter_warps_distinct(slots):
        slots = np.asarray(slots) % 8
        return all(len(set(slots[q * 8 : q * 8 + 8])) == 8 for q in range(4))

    k1s, l1s = LANES >> 2, LANES & 3
    writes1 = {(k1, int(s)) for k1 in range(8) for s in k1 * ROW + LANES}
    reads1 = {(int(s) // ROW, int(s)) for l2 in range(8) for s in k1s * ROW + l1s + 4 * l2}
    assert writes1 == reads1 and len(writes1) == 256
    assert all(half_warps_distinct(k1 * ROW + LANES) for k1 in range(8))
    assert all(half_warps_distinct(k1s * ROW + l1s + 4 * l2) for l2 in range(8))
    writes2 = [_swz(k1s, l1s, k2a) for k2a in range(8)]
    reads2 = [_swz(LANES & 7, l1, (LANES >> 3) + 4 * r) for r in range(2) for l1 in range(4)]
    assert sorted(np.concatenate(writes2)) == list(range(256))
    assert sorted(np.concatenate(reads2)) == list(range(256))
    assert all(quarter_warps_distinct(s) for s in writes2 + reads2)
    # the power spectrum's f32 writes: 32 distinct banks a warp
    for i in range(4):
        k = LANES + 32 * i
        assert len(set(k % 32)) == 32 and len(set((256 - k) % 256 % 32)) == 32


def test_fbank_twiddles_are_the_roots_of_unity():
    tw1, tw23 = fk.fft_twiddles()
    assert tw1.shape == (256, 2) and tw1.dtype == np.float32
    assert tw23.shape == (161, 2) and tw23.dtype == np.float64
    k1, lane = np.divmod(np.arange(256), 32)
    k2a, l1 = np.divmod(np.arange(32), 4)
    exact1 = np.exp(-2j * np.pi * k1 * lane / 256)
    exact23 = np.concatenate([np.exp(-2j * np.pi * k2a * l1 / 32),
                              np.exp(-2j * np.pi * np.arange(129) / 512)])
    assert fk.TW3 == 32
    np.testing.assert_array_equal(tw1[:, 0], exact1.real.astype(np.float32))
    np.testing.assert_array_equal(tw1[:, 1], exact1.imag.astype(np.float32))
    np.testing.assert_array_equal(tw23[:, 0], exact23.real)
    np.testing.assert_array_equal(tw23[:, 1], exact23.imag)


def _fft256_model(u, tw):
    """fbank.cu's fft256_f64: the 8 x 8 x 4 schedule on u[j][:, lane] =
    a[lane + 32 j] with the larger instances' f64 table; returns zi with
    zi[i][:, lane] = Z[lane + 32 i]."""
    k1s, l1s = LANES >> 2, LANES & 3
    scr = np.zeros((u[0].shape[0], 8 * ROW), u[0].dtype)
    a = _dft8(u)
    for k1 in range(8):
        scr[:, k1 * ROW + LANES] = a[k1] * tw[32 * k1 + LANES] if k1 else a[0]
    a = _dft8([scr[:, k1s * ROW + l1s + 4 * l2] for l2 in range(8)])
    for k2a in range(8):
        scr[:, _swz(k1s, l1s, k2a)] = a[k2a] * tw[fk.TWL_32 + 4 * k2a + l1s] if k2a else a[0]
    zi = [None] * 8
    for r in range(2):
        e = _dft4(*[scr[:, _swz(LANES & 7, l1, (LANES >> 3) + 4 * r)] for l1 in range(4)])
        for k2b in range(4):
            zi[r + 2 * k2b] = e[k2b]
    return zi


def _fft_power_model_large(y: np.ndarray, nfft: int, late=np.complex128) -> np.ndarray:
    """|X[k]|^2 for k < nfft / 2 of the real frames y [F, nfft] as fbank.cu's
    larger instances compute it (nfft = 512 R): stage 1 in complex64, for
    each pair of q ({0, R/2}, {q, R - q}) a_q[m] = w_NZ^(m q) sum_r z[m + 256
    r] w_R^(r q) on lane m % 32; two 256-point FFTs in ``late`` (complex128:
    f64); the split pairing Z[R k + q] with the pair's mirror on lane (32 -
    lane) % 32 (q = 0) or 31 - lane; |X|^2 rounded to f32. Every bin is
    written once (a bin left NaN fails the tests)."""
    R, NZ = nfft // fk.FFT_SIZE, nfft // 2
    twa, twd = fk.fft_twiddles(nfft)
    wa = (twa[:, 0] + 1j * twa[:, 1]).astype(np.complex64)
    wd = (twd[:, 0] + 1j * twd[:, 1]).astype(late)
    F = y.shape[0]
    z = (y[:, 0::2] + 1j * y[:, 1::2]).astype(np.complex64)
    P = np.full((F, NZ), np.nan, np.float32)
    quarter = np.float32(0.25)

    def split(k, za, zb):
        e2 = (za.real + zb.real) + 1j * (za.imag - zb.imag)  # 2E
        o2 = (za.imag + zb.imag) + 1j * (zb.real - za.real)  # 2O
        t = o2 * wd[fk.TWL_SPLIT + k]
        P[:, k] = quarter * (np.abs(e2 + t) ** 2).astype(np.float32)
        m = k != 0
        P[:, (NZ - k)[m]] = quarter * (np.abs(e2 - t) ** 2).astype(np.float32)[:, m]

    for g in range(R // 2):
        q0, q1 = g, R // 2 if g == 0 else R - g
        s0, s1 = [], []
        for j in range(8):
            a0 = a1 = np.zeros((F, 32), np.complex64)
            for r in range(R):
                zz = z[:, LANES + 32 * j + 256 * r]
                a0 = a0 + zz * wa[256 * R + (r * q0) % R]
                a1 = a1 + zz * wa[256 * R + (r * q1) % R]
            s0.append((a0 * wa[256 * q0 + LANES + 32 * j]).astype(late))
            s1.append((a1 * wa[256 * q1 + LANES + 32 * j]).astype(late))
        za, zb = _fft256_model(s0, wd), _fft256_model(s1, wd)
        if g == 0:
            partner = (32 - LANES) % 32
            for i in range(4):
                zo = za[7 - i][:, partner]
                zo[:, 0] = za[(8 - i) % 8][:, 0] if i else za[0][:, 0]
                split(R * (LANES + 32 * i), za[i], zo)
            P[:, NZ // 2] = np.abs(za[4][:, 0]) ** 2  # X[NZ/2] = Z*[NZ/2], on lane 0
            for i in range(4):
                split(R * (LANES + 32 * i) + R // 2, zb[i], zb[7 - i][:, 31 - LANES])
        else:
            for i in range(8):
                split(R * (LANES + 32 * i) + q0, za[i], zb[7 - i][:, 31 - LANES])
    return P


# fbank.cu's instances (Geom<R>): frames a tile and warps a block, by FFT size
FBANK_TILES = {512: (32, 8), 1024: (16, 8), 2048: (16, 8), 4096: (8, 4), 8192: (4, 2)}


def _fbank_smem_bytes(nfft: int, shift: int, M: int, mel_steps: int) -> int:
    """The dynamic shared memory of a block of fbank.cu's ``nfft``-point
    instance (its launch computes the same): the waveform span of a tile,
    then at 512 points the window, the twiddles, the mel schedule and a
    4 KB buffer a warp; above it a warp's transposes' buffer (8 rows of 36
    f64 points) and power spectrum (nfft / 2 f32)."""
    tile, warps = FBANK_TILES[nfft]
    span = -(-((tile - 1) * shift + nfft) // 4) * 4
    if nfft == fk.FFT_SIZE:
        rounds = -(-M // 32)
        return 4 * (span + nfft + 4 * 162 + 2 * 256 + 32 * mel_steps + 32 * rounds
                    + -(-rounds // 4) * 4 + warps * 4 * fk.FFT_POINTS)
    return 4 * span + warps * (8 * 36 * 16 + nfft // 2 * 4)


# (sample rate, window, shift, DFT size) of the larger instances
HIGH_RATES = [(22050.0, 551, 220, 1024), (32000.0, 800, 320, 1024), (44100.0, 1102, 441, 2048),
              (48000.0, 1200, 480, 2048), (96000.0, 2400, 960, 4096),
              (192000.0, 4800, 1920, 8192)]


@pytest.mark.parametrize("sr,W,shift,nfft", HIGH_RATES)
def test_fbank_larger_fft_schedules_reproduce_the_real_dft(sr, W, shift, nfft):
    """The 1024-, 2048-, 4096- and 8192-point schedules give the real DFT's power
    with the 512-point error floor (under 2e-7 of the frame's peak energy
    in every bin, bins 60 dB and more down included); an impulse and a
    tone at a bin give their exact spectra."""
    assert fk._geometry(40000, sr)[:3] == (W, shift, nfft)
    n = int(sr) + W
    wave = fc.waveform_inputs([n], n, seed=nfft, dev="cpu", sample_rate=sr)["waveforms"][0].numpy()
    y = _windowed_frames(wave, 40, W=W, shift=shift, nfft=nfft)
    P = _fft_power_model_large(y, nfft).astype(np.float64)
    ref = np.abs(np.fft.rfft(y.astype(np.float64), axis=1)[:, : nfft // 2]) ** 2
    assert (ref.min(1) < 1e-6 * ref.max(1)).any()
    err = np.abs(P - ref) / ref.max(1, keepdims=True)
    assert err.max() < 2e-7, err.max()
    imp = np.zeros((1, nfft), np.float32)
    imp[0, 5] = 1.0
    np.testing.assert_allclose(_fft_power_model_large(imp, nfft)[0], np.ones(nfft // 2), rtol=1e-6)
    k = nfft // 2 - 37
    tone = np.cos(2 * np.pi * k * np.arange(nfft) / nfft).astype(np.float32)[None]
    p = _fft_power_model_large(tone, nfft)[0]
    assert abs(p[k] / (nfft / 2) ** 2 - 1) < 1e-6 and np.delete(p, k).max() < 1e-6 * (nfft / 2) ** 2


@pytest.mark.parametrize("sr,W,shift,nfft", HIGH_RATES)
def test_fbank_larger_ffts_through_the_mel_banks_match_the_plain_version(sr, W, shift, nfft):
    """The kernel's tables at 22.05 to 192 kHz (the window zero past W, the
    mel schedule over nfft / 2 bins): the model's spectrum through them
    against fbank_plain by the goldens' rule; each instance's shared memory
    keeps two blocks an SM (228 KB, 1 KB reserved a block)."""
    S = int(0.25 * sr) + W
    a = fc.waveform_inputs([S], S, seed=W, dev="cpu", sample_rate=sr)
    ref, lengths = fk.fbank_plain(a["waveforms"], a["num_samples"], sr)
    n = int(lengths[0])
    tab = fk._kernel_tables(torch.device("cpu"), W, 80, sr)
    assert tab["nfft"] == nfft and tab["window"].shape == (nfft,) and not tab["window"][W:].any()
    P = _fft_power_model_large(_windowed_frames(a["waveforms"][0].numpy(), n, W, shift, nfft), nfft)
    mel = _mel_schedule_model(P, tab["mel_w"].numpy(), tab["mel_meta"].numpy(),
                              tab["mel_len"].numpy(), 80)
    got = np.log(np.maximum(mel, np.float32(1.1920928955078125e-07))).astype(np.float64)
    want = ref[0, :n].double().numpy()
    loud = want - want.max(1, keepdims=True) >= -fc.DB70
    assert np.abs(got - want)[loud].max() < fc.FBANK_LOG_TOL
    lin = np.abs(np.exp(got) - np.exp(want)) / np.exp(want).max(1, keepdims=True)
    assert lin.max() < fc.FBANK_LIN_TOL
    assert 2 * (_fbank_smem_bytes(nfft, shift, 80, tab["mel_steps"]) + 1024) <= 228 * 1024


def test_fbank_larger_fft_in_f64_after_stage_1_keeps_the_quiet_bins():
    """At 96 kHz (4096 points) as at 16 kHz: with only the first (radix-8)
    stage in f32 the worst log error of the mel bins within 70 dB of their
    frame's peak against float64 is 1.9e-5 on these inputs; an FFT in f32
    throughout loses 8.4e-5, over four times as much."""
    W, shift, nfft = 2400, 960, 4096
    banks = fk._dft_mel_matrices(W, nfft, 80, 96000.0)[2][: nfft // 2].astype(np.float64)
    worst = {np.complex64: 0.0, np.complex128: 0.0}
    for b in range(4):
        wav = fc.waveform_inputs([98000], 98000, seed=b, dev="cpu", sample_rate=96000.0)
        y = _windowed_frames(wav["waveforms"][0].numpy(), 40, W, shift, nfft)
        exact = np.abs(np.fft.rfft(y.astype(np.float64), axis=1)[:, : nfft // 2]) ** 2
        want = np.log(np.maximum(exact @ banks, 1.1920928955078125e-07))
        loud = want - want.max(1, keepdims=True) >= -fc.DB70
        for late in worst:
            got = np.log(np.maximum(
                _fft_power_model_large(y, nfft, late).astype(np.float64) @ banks, 1.1920928955078125e-07))
            worst[late] = max(worst[late], float(np.abs(got - want)[loud].max()))
    assert worst[np.complex128] < 1.2e-4 and worst[np.complex64] > 2 * worst[np.complex128], worst


@pytest.mark.parametrize("nfft", [1024, 2048, 4096, 8192])
def test_fbank_larger_twiddles_are_the_roots_of_unity(nfft):
    R, NZ = nfft // 512, nfft // 2
    twa, twd = fk.fft_twiddles(nfft)
    assert twa.shape == (257 * R, 2) and twa.dtype == np.float32
    assert twd.shape == (fk.TWL_SPLIT + NZ, 2) and twd.dtype == np.float64
    q, m = np.divmod(np.arange(256 * R), 256)
    exact_a = np.concatenate([np.exp(-2j * np.pi * q * m / NZ), np.exp(-2j * np.pi * np.arange(R) / R)])
    k1, lane = np.divmod(np.arange(256), 32)
    k2a, l1 = np.divmod(np.arange(32), 4)
    exact_d = np.concatenate([np.exp(-2j * np.pi * k1 * lane / 256), np.exp(-2j * np.pi * k2a * l1 / 32),
                              np.exp(-2j * np.pi * np.arange(NZ) / nfft)])
    np.testing.assert_array_equal(twa[:, 0], exact_a.real.astype(np.float32))
    np.testing.assert_array_equal(twa[:, 1], exact_a.imag.astype(np.float32))
    np.testing.assert_array_equal(twd[:, 0], exact_d.real)
    np.testing.assert_array_equal(twd[:, 1], exact_d.imag)


def _fft_power_model_radix2(y: np.ndarray, nfft: int) -> np.ndarray:
    """fbank.cu's large instance on frames y [F, nfft] f32: the packed
    points, a first radix-2 decimation-in-frequency stage in f32 (f32
    twiddles), the other stages in f64, Z at bit-reversed positions, then
    the split in f64; the power spectrum rounded to f32 [F, nfft / 2]."""
    NZ = nfft // 2
    tw1, tw = fk.fft_twiddles(nfft)
    w1 = (tw1[:, 0] + 1j * tw1[:, 1]).astype(np.complex64)
    wd = tw[:, 0] + 1j * tw[:, 1]
    z = (y[:, 0::2] + 1j * y[:, 1::2]).astype(np.complex64)
    a, b = z[:, : NZ // 2], z[:, NZ // 2 :]
    Z = np.concatenate([a + b, (a - b) * w1], 1).astype(np.complex128)
    log_nz = NZ.bit_length() - 1
    for s in range(1, log_nz):
        h = NZ >> (s + 1)
        Zr = Z.reshape(Z.shape[0], -1, 2, h)
        top, bot = Zr[:, :, 0].copy(), Zr[:, :, 1].copy()
        Zr[:, :, 0] = top + bot
        Zr[:, :, 1] = (top - bot) * wd[np.arange(h) << s]
    k = np.arange(NZ)
    rev = np.array([int(format(i, f"0{log_nz}b")[::-1], 2) for i in k])
    Zk = Z[:, rev]
    za, zb = Zk[:, : NZ // 2], Zk[:, (NZ - k[: NZ // 2]) % NZ]
    e = (za.real + zb.real) + 1j * (za.imag - zb.imag)
    od = (za.imag + zb.imag) + 1j * (zb.real - za.real)
    t2 = od * wd[NZ // 2 :][: NZ // 2]
    P = np.zeros((y.shape[0], NZ), np.float32)
    P[:, : NZ // 2] = 0.25 * np.abs(e + t2) ** 2
    P[:, NZ - k[1 : NZ // 2]] = 0.25 * np.abs(e - t2)[:, 1:] ** 2
    P[:, NZ // 2] = np.abs(Zk[:, NZ // 2]) ** 2
    return P


@pytest.mark.parametrize("sr,W,shift", [(352800.0, 8820, 3528), (384000.0, 9600, 3840)])
def test_fbank_large_instance_through_the_mel_banks_matches_float64(sr, W, shift):
    """The large instance's radix-2 schedule (16384 points) and its tables
    (the mel schedule as (bin, first DFT bin) pairs) against the float64
    DFT through the same banks by the goldens' rule (the card's tests hold
    the kernel to fbank_plain, whose DFT bases take seconds to build here),
    and its power spectrum against float64's within the 512-point error
    floor; its workspace is shared memory at 16384 points and a slice a
    block above, whatever the number of frames."""
    S = int(0.05 * sr) + W
    a = fc.waveform_inputs([S], S, seed=W, dev="cpu", sample_rate=sr)
    n = 1 + (S - W) // shift
    tab = fk._kernel_tables(torch.device("cpu"), W, 80, sr)
    nfft = tab["nfft"]
    assert nfft == 16384 and tab["mel_meta"].shape == (3, 32, 2) and not tab["window"][W:].any()
    y = _windowed_frames(a["waveforms"][0].numpy(), n, W, shift, nfft)
    P = _fft_power_model_radix2(y, nfft)
    exact = np.abs(np.fft.rfft(y.astype(np.float64), axis=1)[:, : nfft // 2]) ** 2
    assert (np.abs(P - exact) / exact.max(1, keepdims=True)).max() < 2e-7
    bins, k0s = tab["mel_meta"][..., 0].numpy(), tab["mel_meta"][..., 1].numpy()
    w, lens = tab["mel_w"].numpy(), tab["mel_len"].numpy()
    mel = np.full((n, 80), np.nan, np.float32)
    row = 0
    for r, L in enumerate(lens):  # the round's 32 lanes at once, each an f32 chain
        acc = np.zeros((n, 32), np.float32)
        for i in range(L):
            acc = acc + P[:, k0s[r] + i] * w[row + i]
        live = bins[r] >= 0
        mel[:, bins[r][live]] = acc[:, live]
        row += L
    got = np.log(np.maximum(mel, np.float32(1.1920928955078125e-07))).astype(np.float64)
    banks = fk.kernel_mel_banks(W, nfft, 80, sr).astype(np.float64)
    want = np.log(np.maximum(exact @ banks, 1.1920928955078125e-07))
    loud = want - want.max(1, keepdims=True) >= -fc.DB70
    assert np.abs(got - want)[loud].max() < fc.FBANK_LOG_TOL
    lin = np.abs(np.exp(got) - np.exp(want)) / np.exp(want).max(1, keepdims=True)
    assert lin.max() < fc.FBANK_LIN_TOL
    assert fk.large_workspace_bytes(16384, 132) == 0
    assert fk.large_workspace_bytes(32768, 132) == 132 * 16384 * 20


@pytest.mark.parametrize("M", [80, 40, 23])
def test_fbank_mel_schedule_gives_back_the_banks(M):
    """Every mel bin on one lane of one round, its weights at their DFT
    bins and zero elsewhere, inside the power spectrum; a round's steps are
    its longest range, the longest ranges first."""
    _, _, mel_t = fk._dft_mel_matrices(400, 512, M, 16000.0)
    banks = mel_t[: fk.FFT_POINTS]
    w, meta, lens = fk.mel_schedule(banks)
    R = -(-M // 32)
    assert w.dtype == np.float32 and w.shape == (lens.sum(), 32) and meta.shape == (R, 32)
    back = np.zeros_like(banks)
    seen, row = [], 0
    for r in range(R):
        for lane in range(32):
            m, k0 = meta[r, lane] >> 16, meta[r, lane] & 0xFFFF
            if m < 0:
                assert not w[row : row + lens[r], lane].any()
                continue
            assert 0 <= k0 and k0 + lens[r] <= fk.FFT_POINTS
            back[k0 : k0 + lens[r], m] += w[row : row + lens[r], lane]
            seen.append(int(m))
        row += lens[r]
    assert sorted(seen) == list(range(M))
    np.testing.assert_array_equal(back, banks)
    ranges = [np.flatnonzero(banks[:, m]) for m in range(M)]
    widths = sorted((int(k[-1] - k[0] + 1) for k in ranges), reverse=True)
    assert list(lens) == [widths[32 * r] for r in range(R)]
    if M == 80:
        assert list(lens) == [16, 6, 2]  # against 4 + 10 + 16 steps with the bins in order
    # a bin without weights keeps its lane, with zero weights: it sums to 0
    empty = banks.copy()
    empty[:, 1] = 0.0
    w2, meta2, lens2 = fk.mel_schedule(empty)
    assert np.count_nonzero((meta2 >> 16) == 1) == 1
    mel = _mel_schedule_model(np.ones((1, fk.FFT_POINTS), np.float32), w2, meta2, lens2, M)[0]
    assert mel[1] == 0.0
    np.testing.assert_allclose(mel, empty.sum(0), rtol=1e-6)


# ---------------------------------------------------------------------------
# int8_matmul (B11): the persistent product's tile schedule, its TMA boxes
# and epilogue boxes, and the routes each check shape takes
# ---------------------------------------------------------------------------

from espresso_tpu_torch.ops import quantization as qz  # noqa: E402

I8_BM, I8_BN, I8_BOX_ROWS, I8_BOX_COLS = 128, 256, 64, 32  # int8_matmul.cu


@pytest.mark.parametrize(
    "M,K,N,w_route,out_route",
    [(39936, 512, 2048, "direct", "tma"), (39936, 2048, 512, "direct", "tma"),
     (1000, 200, 300, "padded", "tma"), (301, 133, 301, "padded", "predicated")],
)
def test_int8_matmul_schedule_covers_every_output_once(M, K, N, w_route, out_route):
    """Tiles of 128 x 256 taken N-inner, tile i by block i % grid (grid =
    min(tiles, 132)); each tile's k-tiles of 128 bytes up to Kp (K rounded
    up to 128: the row pass's zeros, or TMA's past K); each consumer
    warpgroup's 64 rows leave in eight [64 x 32] boxes, clipped at M and N:
    every output element is written once. Each check shape's routes."""
    w = fc.int8_inputs(2, K, N, seed=0, dev="cpu")["w_q"]
    # the product's TMA stores need f32 rows on 16 bytes, else it stores
    # through a predicate (int8_matmul.cu)
    assert qz.int8_w_route(w) == w_route
    assert ("tma" if N * 4 % 16 == 0 else "predicated") == out_route
    Kp = max(-(-K // qz.K_TILE) * qz.K_TILE, qz.K_TILE)
    assert Kp % 128 == 0 and Kp - K < 128
    ntn, mt = -(-N // I8_BN), -(-M // I8_BM)
    tiles, grid = mt * ntn, min(mt * ntn, 132)
    per_block = [list(range(b, tiles, grid)) for b in range(grid)]
    assert sorted(t for ts in per_block for t in ts) == list(range(tiles))
    # consecutive tiles of a block (stride grid) walk N fastest: a block's
    # neighbours at one moment share the same rows of xq
    rows_cov = np.zeros(mt * I8_BM, np.int64)
    cols_cov = np.zeros(ntn * I8_BN, np.int64)
    boxes = set()
    for t in range(tiles):
        m0, n0 = t // ntn * I8_BM, t % ntn * I8_BN
        for cw in range(2):
            for c in range(I8_BN // I8_BOX_COLS):
                boxes.add((m0 + I8_BOX_ROWS * cw, n0 + I8_BOX_COLS * c))
        if t % ntn == 0:
            rows_cov[m0:m0 + I8_BM] += 1
        if t < ntn:
            cols_cov[n0:n0 + I8_BN] += 1
    # the boxes are the [64 x 32] grid over the tiles, so clipped at M and N
    # they cover [0, M) x [0, N) once
    want = {(r, c) for r in range(0, mt * I8_BM, I8_BOX_ROWS) for c in range(0, ntn * I8_BN, I8_BOX_COLS)}
    assert boxes == want
    assert (rows_cov[:M] == 1).all() and (cols_cov[:N] == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1000, 200, 300), (67, 133, 45), (9, 1, 3)])
def test_int8_matmul_routes_model_is_the_plain_version_bit_for_bit(M, K, N, dtype):
    """The kernel's arithmetic along its routes, in numpy: the row pass
    (16-byte chunks of E elements where K allows, else one by one) writes
    xq [M, Kp] with zeros past K; w is read directly or from the zero-padded
    [N, Kp] copy; int32 sums over the 128-byte k-tiles; the epilogue's two
    f32 products in order. Bit for bit the plain version."""
    a = fc.int8_inputs(M, K, N, seed=M + K, dev="cpu", dtype=dtype)
    x = a["x"].float().numpy()
    Kp = max(-(-K // qz.K_TILE) * qz.K_TILE, qz.K_TILE)
    amax = np.abs(x).max(1) if K else np.zeros(M, np.float32)
    xs = (np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 127.0)).astype(np.float32)
    xq = np.zeros((M, Kp), np.int32)
    xq[:, :K] = np.clip(np.rint(x / xs[:, None]), -127, 127)  # IEEE quotient, half to even
    wq = a["w_q"].t().numpy().astype(np.int32)  # [N, K]
    if qz.int8_w_route(a["w_q"]) == "padded":
        wq = np.pad(wq, ((0, 0), (0, Kp - K)))
    else:
        xq = xq[:, :K]
    acc = np.zeros((M, N), np.int64)
    for k0 in range(0, xq.shape[1], 128):
        acc += xq[:, k0:k0 + 128].astype(np.int64) @ wq[:, k0:k0 + 128].T.astype(np.int64)
    out = (acc.astype(np.float32) * xs[:, None]).astype(np.float32) * a["w_scale"].numpy()[None, :]
    want = qz.int8_matmul_plain(a["x"], a["w_q"], a["w_scale"]).numpy()
    np.testing.assert_array_equal(out.astype(np.float32), want)
