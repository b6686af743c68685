"""The one-time weight layout of the ``lstm_step_reorder`` kernel, on the
CPU: a permutation of ``beam_kernel_weights``' gate kernels, whose inverse
gives them back exactly, with the gate columns interleaved as the kernel's
epilogue reads them."""

import pytest
import torch

from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel
from espresso_tpu_torch.ops import decode_kernels as dk


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
    # block); the longest T fits one block
    assert 3 * (ak.rel_attention_smem_bytes(156) + 1024) <= 228 * 1024
    assert ak.rel_attention_smem_bytes(ak.REL_ATTENTION_MAX_T) <= ak.SMEM_LIMIT
    assert ak.rel_attention_smem_bytes(ak.REL_ATTENTION_MAX_T + 1) > ak.SMEM_LIMIT
    assert ak.REL_ATTENTION_MAX_T == 1344
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


def _windowed_frames(wave: np.ndarray, n_frames: int) -> np.ndarray:
    """The plain version's frames before the DFT: DC removed, pre-emphasis,
    the povey window, zero-padded to 512 (f32)."""
    W, shift = 400, 160
    x = np.stack([wave[t * shift : t * shift + W] for t in range(n_frames)]).astype(np.float32)
    x = x - x.mean(1, keepdims=True)
    prev = np.concatenate([x[:, :1], x[:, :-1]], 1)
    y = (x - np.float32(fk.PREEMPHASIS) * prev) * fk.povey_window(W)
    return np.pad(y, ((0, 0), (0, fk.FFT_SIZE - W))).astype(np.float32)


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
