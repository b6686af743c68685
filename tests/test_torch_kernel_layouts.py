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
