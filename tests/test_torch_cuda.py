"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (marked ``cuda``). Imports no JAX, so on a machine
without it the file runs on its own, without the suite's conftest (which
imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
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


# the redesigned B1's edges (64-row query and key tiles, the [128 j'] skew
# window, TMA boxes that stop at T, scores in registers for the first three
# key tiles and in shared memory past them): T' = 1, 63, 64, 65, 129, 156,
# 200, 1024 and the longest T' it takes, each with ragged key masks: the
# first utterance full, the last with one valid key; at today's bound (2
# bf16 ulps of the output's largest magnitude)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 156, 200, 1024, 1344])
def test_rel_attention_kernel_at_tiling_edges(dev, T):
    from espresso_tpu_torch.ops.train_kernel_checks import bf16_ulp

    q_u, q_v, k, v, p, key_valid = _inputs(3, T, seed=T + 3, dev=dev)
    key_valid[2] = torch.arange(T, device=dev) < 1
    args = (q_u, q_v, k, v, p, key_valid, H, 0.125)
    out = rel_attention(*args)
    torch.cuda.synchronize()
    ref = rel_attention_reference(*args)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err <= 2 * bf16_ulp(ref.float().abs().max().item()), err


def test_rel_attention_rejects_a_length_past_its_shared_memory(dev):
    # past the long-row mode's limit (4096; the score rows' limit, 1344, no
    # longer stops it)
    from espresso_tpu_torch.ops.attention_kernels import REL_ATTENTION_MAX_T

    args = _inputs(1, REL_ATTENTION_MAX_T + 1, seed=0, dev=dev) + (H, 0.125)
    before = rel_attention.launches
    with pytest.raises(ValueError, match="takes T <= 4096"):
        rel_attention(*args)
    assert rel_attention.launches == before


# the long-row mode (T' past 1344): two passes over the key tiles; two
# heads (the plain version's [T, T, H, d] position gather at T' = 4096 and
# eight heads would take 17 GB), ragged key masks with one utterance of
# one valid key; at today's bound (2 bf16 ulps)
@pytest.mark.parametrize("B,T", [(3, 1345), (2, 1500), (2, 2048), (1, 4096)])
def test_rel_attention_long_rows_match_plain_version(dev, B, T):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    tc.check_rel_attention(*tc.long_attention_inputs(B, T, seed=T, dev=dev))


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


# the cluster tiling's edges: BK = 2550 (not a multiple of the 64-row tile),
# J = 128 and 640 (d tiles dealt unevenly over the cluster), V = 67 and
# 1032 (a ragged last tile), n = 1 and 32, a label bias with and without
# the eos fold
@pytest.mark.parametrize(
    "B,K,V,J,n,fold,bias",
    [
        (255, 10, 1024, 512, 12, False, False),
        (255, 10, 1032, 640, 32, True, True),
        (8, 4, 1032, 128, 32, False, True),
        (8, 4, 1024, 640, 1, True, False),
        (3, 4, 67, 128, 1, False, True),
        (255, 10, 5003, 512, 32, False, True),
        (64, 4, 1032, 512, 1, True, True),
    ],
)
def test_fused_joint_topk_kernel_at_tiling_edges(dev, B, K, V, J, n, fold, bias):
    a = kc.joint_inputs(B, K, V, J, J, seed=V + J + n, dev=dev, bias=bias)
    kc.check_joint(a, K, n, blank=0, eos=2, fold=fold)


# the wide instance (J or H above 1024: feat and h through the ring, h by
# a global scratch, four d tiles a warpgroup): J = H = 1088 and 2048, V =
# 1024 and 5003, with and without a label bias, with an eos fold; J and H
# apart; BK not a multiple of 64; at today's bound (0.02)
@pytest.mark.parametrize(
    "B,K,V,J,H_,n,fold,bias",
    [
        (256, 10, 1024, 1088, 1088, 12, False, False),
        (256, 10, 5003, 2048, 2048, 12, False, False),
        (255, 10, 1024, 2048, 2048, 32, True, True),
        (8, 4, 5003, 1088, 1088, 12, False, True),
        (3, 4, 1032, 2048, 512, 1, True, False),
        (5, 4, 1024, 512, 2048, 16, False, True),
    ],
)
def test_fused_joint_topk_wide_instance_matches_plain_version(dev, B, K, V, J, H_, n, fold, bias):
    a = kc.joint_inputs(B, K, V, J, H_, seed=V + J + H_ + n, dev=dev, bias=bias)
    kc.check_joint(a, K, n, blank=0, eos=2, fold=fold)


@pytest.mark.parametrize("B,K,H_,L", [(256, 10, 512, 2), (1, 1, 64, 1), (3, 4, 128, 3)])
def test_lstm_step_reorder_kernel_matches_plain_version(dev, B, K, H_, L):
    kc.check_lstm(kc.lstm_inputs(B, K, H_, L, seed=B + H_, dev=dev), B, K)


# the 128 x 128 tiling's edges: BK = 1, 12 and 2550, H = 64 and 1024, L = 1
# and 3, every row dead and every row live (dead rows bit for bit)
@pytest.mark.parametrize(
    "B,K,H_,L,live",
    [
        (1, 1, 512, 2, 0.8),
        (1, 12, 512, 2, 0.8),
        (255, 10, 512, 2, 0.8),
        (3, 4, 64, 1, 0.8),
        (2, 6, 1024, 3, 0.8),
        (255, 10, 512, 2, 0.0),
        (255, 10, 512, 2, 1.0),
        (4, 3, 1024, 1, 1.0),
    ],
)
def test_lstm_step_reorder_kernel_at_tiling_edges(dev, B, K, H_, L, live):
    a = kc.lstm_inputs(B, K, H_, L, seed=B + H_ + L, dev=dev, live_frac=live)
    kc.check_lstm(a, B, K)


# B7 on an LSTM LM's gate-padded stack: the beam_lm point's LM (embed 512
# padded to H = 1024, 3 layers) at BK = 2560 and 12, the LM config's
# default H = 650 (padded to 704: the padded channels stay 0), and the
# recipe's lstm_lm_librispeech (4 x 800, padded to Hp = 832: 13 column tiles
# of 64); some rows dead
@pytest.mark.parametrize(
    "B,K,E,H_,L", [(256, 10, 512, 1024, 3), (1, 12, 512, 1024, 3), (3, 4, 48, 650, 2),
                   (256, 10, 800, 800, 4), (1, 12, 800, 800, 4), (5, 3, 800, 800, 4)]
)
def test_lstm_step_reorder_kernel_at_lm_shapes(dev, B, K, E, H_, L):
    a = kc.lstm_lm_inputs(B, K, E, H_, L, seed=B + E, dev=dev)
    kc.check_lstm(a, B, K)
    h, c = dk.unpack_lstm_state(dk.lstm_step_reorder(**a, B=B, K=K), L)
    assert not h[..., H_:].any() and not c[..., H_:].any()


def test_fused_joint_topk_with_an_lm_label_bias_in_a_two_round_step(dev):
    """B6 at V = 1024 with the beam decoder's label bias (an LM's log-probs
    over V_lm = 1023, shifted past the blank, at lm_weight 0.47), for two
    rounds: the second scores the first's kept candidates."""
    from espresso_tpu_torch.decode.transducer_beam import lm_label_bias

    B, K, V, J = 8, 10, 1024, 512
    g = torch.Generator().manual_seed(12)
    a = kc.joint_inputs(B, K, V, J, J, seed=12, dev=dev)
    for _ in range(2):
        lp = torch.log_softmax(3 * torch.randn(B * K, V - 1, generator=g), -1).to(dev)
        a["label_bias"] = lm_label_bias(lp, V, 0.47)
        kc.check_joint(a, K, K + 2)
        _, vals, flat, _ = dk.fused_joint_topk_reference(**a, K=K, n_cand=K + 2)
        top, idx = dk.rows_topk(vals, flat, K + 2)
        a["scores"] = top[:, :K].contiguous()
        src = (torch.arange(B, device=dev)[:, None] * K + idx[:, :K] // V).reshape(-1)
        a["feat"] = torch.tanh(a["feat"][src].float() + 0.1).bfloat16()


def _small_model(dev, pred_embed=128):
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
    from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel

    cfg = TransducerConfig(
        feat_dim=80, vocab_size=1024,
        encoder=SpeechTransformerConfig(
            encoder_layer_type="conformer", encoder_pos_type="relative",
            encoder_embed_dim=256, encoder_ffn_dim=1024, encoder_layers=2, encoder_heads=4,
            depthwise_conv_kernel_size=31,
        ),
        pred_embed_dim=pred_embed, pred_hidden_size=256, pred_layers=2, joint_dim=256,
    )
    torch.manual_seed(0)
    model = TransducerModel(cfg).to(dev, torch.bfloat16).eval()
    with torch.no_grad():
        model.joint.fc_out.weight.mul_(6)
        model.joint.fc_out.bias.mul_(6)
    return model


def test_lm_fused_beam_decode_kernels_match_plain_versions(dev):
    """The LM-fused beam decode of 4 utterances (a 2-layer model with a
    prediction net of embedding 128 < hidden 256, an LSTM LM of embed 128,
    hidden 320, 2 layers, V_lm = 1023, all bf16) through the kernels, with
    every kernel's launches counted, against the same decode through the
    plain versions: top-1 scores within 1 %."""
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode import transducer_beam
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig

    model = _small_model(dev)
    torch.manual_seed(1)
    lm = LSTMLanguageModel(LSTMLMConfig(
        vocab_size=1023, embed_dim=128, hidden_size=320, out_embed_dim=256, num_layers=2,
        dropout=0.0,
    )).to(dev, torch.bfloat16).eval()
    g = torch.Generator().manual_seed(2)
    batch = {"src_frames": torch.randn(4, 200, 80, generator=g).to(dev, torch.bfloat16),
             "src_lengths": torch.tensor([200, 180, 150, 101], device=dev)}
    beam = dict(beam_size=4, expansion_beta=2, expansion_gamma=2.3, max_num_expansions_per_step=2,
                prefix_alpha=1, lm=lm, lm_weight=0.47)
    dic = AsrDictionary(enable_bos=True)
    decoder = transducer_beam.TransducerBeamSearchDecoder(model, dic, **beam)
    assert decoder.pred_w["Hp"] == 256 and decoder.lm_w["Hp"] == 320
    for f in dk.KERNELS:
        f.launches = 0
    got = decoder.decode(batch)
    with torch.no_grad():
        T_enc = model.encode(batch["src_frames"], batch["src_lengths"]).encoder_out.shape[1]
    assert {f.__name__: f.launches for f in dk.KERNELS} == {
        "fused_joint_topk": 3 * T_enc, "lstm_step_reorder": 2 * 2 * T_enc,
        "aes_merge": 3 * T_enc, "aes_backtrace": 1,
    }
    plain = [(transducer_beam, f.__name__, getattr(dk, f.__name__ + "_reference")) for f in dk.KERNELS]
    saved = [(m, n, getattr(m, n)) for m, n, _ in plain]
    try:
        for m, n, fn in plain:
            setattr(m, n, fn)
        want = transducer_beam.TransducerBeamSearchDecoder(model, dic, **beam).decode(batch)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    assert sum(len(h[0]["tokens"]) for h in got) > 0
    rel = [abs(g_[0]["score"] - w[0]["score"]) / abs(w[0]["score"]) for g_, w in zip(got, want)]
    assert max(rel) <= 0.01, rel


@pytest.mark.parametrize("B,K", [(256, 10), (1, 1), (1, 4), (5, 16), (5, 20), (3, 40)])
def test_aes_merge_kernel_matches_plain_version(dev, B, K):
    kc.check_merge(kc.merge_inputs(B, K, seed=K, dev=dev))


@pytest.mark.parametrize("B,K", [(256, 10), (1, 1), (1, 4), (5, 16), (5, 20)])
def test_aes_merge_kernel_folds_the_blank_add(dev, B, K):
    """With blank_lp: against the plain version, and bit for bit the call on
    the pre-added scores (check_merge); ties, all-NEG_INF rows and a single
    live column among the rows."""
    kc.check_merge(kc.merge_inputs(B, K, seed=K + 1, dev=dev, blank_lp=True))


@pytest.mark.parametrize(
    "T,B,K,n_exp", [(156, 256, 10, 2), (1, 1, 1, 1), (37, 3, 4, 1), (300, 2, 40, 3)]
)
def test_aes_backtrace_kernel_matches_plain_version(dev, T, B, K, n_exp):
    kc.check_backtrace(kc.backtrace_inputs(T, B, K, n_exp, V=1024, seed=T, dev=dev), n_exp)


# the tabulated B9's edges: K from one beam to past a warp of walkers,
# T' from one frame to more than one chunk of staged frames, with the
# cases its tables must reproduce (order, msrc and esrc entries outside
# [0, K), inactive frames inside a length, slots from-pool through every
# merge round), bit for bit
@pytest.mark.parametrize("K", [1, 4, 10, 20, 33])
@pytest.mark.parametrize("T", [1, 37, 156, 1024])
def test_aes_backtrace_kernel_at_edges(dev, T, K):
    kc.check_backtrace(kc.backtrace_inputs(T, 5, K, 2, V=1024, seed=T + K, dev=dev, edges=True), 2)


def test_decode_kernels_reject_what_they_do_not_take(dev):
    a = kc.joint_inputs(2, 4, 128, 64, 64, seed=0, dev=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.fused_joint_topk(**dict(a, enc_t=a["enc_t"].float()), K=4, n_cand=6)
    with pytest.raises(ValueError, match="scores"):
        dk.fused_joint_topk(**dict(a, scores=a["scores"][:1]), K=4, n_cand=6)
    with pytest.raises(ValueError, match="n_cand"):
        dk.fused_joint_topk(**a, K=4, n_cand=33)
    # J and H up to 2048 take the wide instance; past it the wrapper raises
    with pytest.raises(ValueError, match="at most 2048"):
        dk.fused_joint_topk(**kc.joint_inputs(2, 4, 128, 2112, 64, seed=0, dev=dev), K=4, n_cand=6)
    with pytest.raises(ValueError, match="at most 2048"):
        dk.fused_joint_topk(**kc.joint_inputs(2, 4, 128, 512, 2064, seed=0, dev=dev), K=4, n_cand=6)
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
    with pytest.raises(ValueError, match="blank_lp"):
        dk.aes_merge(**m, round_j=0, blank_lp=m["pool_scores"].t())
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


# the redesigned B5's tilings' edges (tiles of 8 values of u x 8 frames, W
# tiles of 64 vocab rows, J split over two warpgroups): J = 128 and 256; U1
# and T not multiples of 8, T = 1, U = 0; V = 67 and V = 5003 with the
# blank in the last column; at today's bound (1e-3 of each gradient's
# largest magnitude, ops/train_kernel_checks.py)
@pytest.mark.parametrize(
    "B,T,U,J,V,blank",
    [
        (4, 40, 20, 128, 1024, 0),
        (4, 40, 20, 256, 1024, 0),
        (3, 37, 12, 512, 1024, 0),
        (2, 1, 5, 512, 1024, 0),
        (2, 9, 0, 512, 1024, 0),
        (3, 19, 6, 512, 67, 66),
        (2, 23, 11, 512, 5003, 5002),
    ],
)
def test_rnnt_joint_bwd_kernel_at_tiling_edges(dev, B, T, U, J, V, blank):
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    before = rk.rnnt_joint_bwd.launches
    tc.check_rnnt_joint(tc.rnnt_inputs(B, T, U, J, V, seed=V + T + J, dev=dev, blank=blank), blank)
    assert rk.rnnt_joint_bwd.launches == before + 1


@pytest.mark.parametrize(
    "B,T,U,J,V", [(16, 256, 100, 512, 1024), (16, 256, 100, 512, 5003), (3, 37, 12, 128, 67)]
)
def test_rnnt_joint_bwd_kernel_is_deterministic(dev, B, T, U, J, V):
    """B5 twice on the same inputs, at the flagship shape, at V = 5003 and
    at a ragged small one: g_enc, g_dec, g_W and g_b bit for bit (partial
    sums in slots, summed in a fixed order, no atomics)."""
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    tc.check_rnnt_joint_bwd_repeats(tc.rnnt_inputs(B, T, U, J, V, seed=V + T, dev=dev), 0)


# the redesigned B4's edges (units of two 64-row tiles of 8 values of u x 8
# frames, an odd tile count leaving a warpgroup without rows, V tiles of 128
# columns padded to an even count): J = 128, 256 and 512; T' and U1 not
# multiples of 8, T' = 1, U = 0; V = 67 and V = 5003 with the blank in the
# last column; at today's bound (1e-3 on log-probs)
@pytest.mark.parametrize(
    "B,T,U,J,V,blank",
    [
        (4, 40, 20, 128, 1024, 0),
        (3, 37, 12, 256, 5003, 5002),
        (3, 37, 12, 512, 67, 66),
        (3, 17, 4, 512, 1024, 3),
        (2, 1, 5, 128, 67, 66),
        (2, 9, 0, 256, 1024, 0),
        (1, 1, 0, 512, 5003, 5002),
    ],
)
def test_rnnt_joint_lp_kernel_at_tiling_edges(dev, B, T, U, J, V, blank):
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    before = rk.rnnt_joint_lp.launches
    tc.check_rnnt_joint_lp(tc.rnnt_inputs(B, T, U, J, V, seed=V + T + J, dev=dev, blank=blank), blank)
    assert rk.rnnt_joint_lp.launches == before + 1


# the redesigned B3's edges (64-row query and key tiles, the [128 j'] skew
# windows, TMA boxes that stop at T): T = 1, 2, 63, 65, 300 and the largest
# T the forward takes (its 64 x T bf16 score rows fill the shared memory at
# T = 1408); B = 40, so that dp sums over more utterances than a block
# holds; at rates 0 and 0.1; at today's bound (8 bf16 ulps)
@pytest.mark.parametrize("B,T", [(3, 1), (3, 2), (2, 63), (2, 65), (2, 300), (2, 1408), (40, 64)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_train_bwd_kernel_at_tiling_edges(dev, B, T, rate):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    tc.check_attention_train(tc.attention_train_inputs(B, T, seed=T + B, dev=dev), H, rate)


@pytest.mark.parametrize("B,T", [(16, 256), (2, 1500)])
def test_rel_attention_train_bwd_kernel_is_deterministic(dev, B, T):
    """B3 twice on the same inputs (the train shape, and past B2's
    shared-memory rows), rate 0.1: every output bit for bit, dp too (each
    query block stores its dp band; the bands are summed in a fixed order,
    no atomics)."""
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(B, T, seed=B + T, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"], a["seed"], a["g"], H,
            ak.HEAD_DIM ** -0.5, 0.1)
    first, second = ak.rel_attention_train_bwd(*args), ak.rel_attention_train_bwd(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq_u", "dq_v", "dk", "dv", "dp"), first, second):
        assert torch.equal(x, y), name


# the redesigned B2's edges (64-row query and key tiles, the [128 j'] skew
# window, TMA boxes that stop at T, scores in registers for three key tiles
# and e for three, shared score rows past them, up to the longest T' it
# takes), each with ragged key masks, the last utterance with one valid
# key, and B = 40; at rates 0 and 0.1, at today's bound (2 bf16 ulps of
# the output's largest magnitude)
@pytest.mark.parametrize(
    "B,T", [(3, 1), (3, 63), (3, 64), (3, 65), (3, 129), (3, 192), (3, 193), (3, 256), (2, 1408),
            (40, 64)],
)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_train_fwd_kernel_at_tiling_edges(dev, B, T, rate):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(B, T, seed=T + 2 * B, dev=dev)
    a["key_valid"][-1] = torch.arange(T, device=dev) < 1
    tc.check_attention_train_fwd(a, H, rate)


def test_rel_attention_train_fwd_rejects_a_length_past_its_shared_memory(dev):
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(1, ak.REL_ATTENTION_TRAIN_MAX_T + 1, seed=0, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"], a["seed"], H, 0.125, 0.1)
    before = ak.rel_attention_train_fwd.launches
    with pytest.raises(ValueError, match="takes T <= 4096"):
        ak.rel_attention_train_fwd(*args)
    assert ak.rel_attention_train_fwd.launches == before
    g = a["g"]
    before = ak.rel_attention_train_bwd.launches
    with pytest.raises(ValueError, match="take T <= 4096"):
        ak.rel_attention_train_bwd(*args[:7], g, H, 0.125, 0.1)
    assert ak.rel_attention_train_bwd.launches == before


# the forward's long-row mode (past T' = 1408) and the backward at the same
# lengths, rates 0 and 0.1: both against the plain versions at today's
# bounds (2 and 8 bf16 ulps); the keep mask is the short mode's
@pytest.mark.parametrize("B,T", [(2, 1409), (2, 1500), (1, 2048), (1, 4096)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_train_kernels_at_long_lengths(dev, B, T, rate):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(B, T, seed=T + B, dev=dev)
    if B > 1:
        a["key_valid"][-1] = torch.arange(T, device=dev) < 1
    tc.check_attention_train(a, H, rate)


# a layer past the relative table's size (encoder_relative_max_size 64 at
# T' = 300): eval through B1 and train through B2/B3 on the expanded
# table, each held to the layer's gather path (weights requested) on the
# same bf16 weights, with the launches counted
def test_clipped_table_layer_runs_the_kernels(dev):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    tc.check_clipped_table_layer(dev, T=300, L=64)


# an utterance whose keys are all masked past a short length (2 of 200),
# beside a full one
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_attention_train_bwd_kernel_with_a_short_utterance(dev, rate):
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    a = tc.attention_train_inputs(2, 200, seed=7, dev=dev)
    a["key_valid"] = (torch.arange(200)[None, :] < torch.tensor([200, 2])[:, None]).to(dev)
    tc.check_attention_train(a, H, rate)


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


# ---------------------------------------------------------------------------
# the feature front's fbank kernel and the w8a8 kernel (inputs and checks in
# ops/front_kernel_checks.py, which chip_smoke.py runs at the flagship
# shapes too)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "num_samples,S",
    [
        ([16400, 9000, 350], 16400),  # ragged, one utterance under one window
        ([399, 400, 16000], 16000),  # the edges of the first frame
        ([4321], 4321),  # B = 1, S not a multiple of the shift
        ([250], 250),  # S under one window: T = 1, no valid frame
        ([100080, 70000] * 3, 100080),  # serving length, several frame tiles
        ([16161, 401, 9999], 16161),  # S odd, not a multiple of the shift
        ([400], 400),  # n = W = S: one frame
        ([164080] * 16, 164080),  # the PCM-fed train point
    ],
)
def test_fbank_kernel_matches_plain_version(dev, num_samples, S):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    errs = fc.check_fbank(fc.waveform_inputs(num_samples, S, seed=S, dev=dev))
    assert errs["log"] < fc.FBANK_LOG_TOL


# 8 kHz (window 200, shift 80): the 256-point DFT as the kernel's even bins
@pytest.mark.parametrize(
    "num_samples,S", [([8200, 4500, 150], 8200), ([50080, 35000] * 2, 50080), ([201], 201)]
)
def test_fbank_kernel_at_8khz(dev, num_samples, S):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    a = fc.waveform_inputs(num_samples, S, seed=S + 8, dev=dev, sample_rate=8000.0)
    errs = fc.check_fbank(a, sample_rate=8000.0)
    assert errs["log"] < fc.FBANK_LOG_TOL
    fc.check_fbank(a, num_mel_bins=40, sample_rate=8000.0)


def test_fbank_kernel_at_40_bins(dev):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    fc.check_fbank(fc.waveform_inputs([16000, 8000], 16000, seed=1, dev=dev), num_mel_bins=40)


@pytest.mark.parametrize(
    "num_samples,S", [([100080, 399, 400, 51234], 100080), ([16161, 401], 16161)]
)
def test_fbank_kernel_at_40_bins_at_edge_shapes(dev, num_samples, S):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    fc.check_fbank(fc.waveform_inputs(num_samples, S, seed=S + 40, dev=dev), num_mel_bins=40)


# 22.05 to 192 kHz: the 1024- to 8192-point instances, 44.1 kHz with
# its odd shift (441 samples); ragged lengths, one under a window, exactly
# one window, one frame and one sample past it
@pytest.mark.parametrize(
    "sample_rate,num_samples,S",
    [
        (22050.0, [22050, 12000, 540], 22050),
        (22050.0, [551, 771], 771),
        (24000.0, [24000, 16001, 599], 24000),
        (32000.0, [32000, 20000, 799, 801], 32000),
        (44100.0, [44100, 30001, 1101], 44100),
        (44100.0, [1102, 1543, 1544], 1544),
        (48000.0, [48000, 31111, 1199], 48000),
        (48000.0, [1200], 1200),
        (88200.0, [88200, 2206], 88200),
        (96000.0, [96000, 50001, 2399, 2400], 96000),
        (96000.0, [2400], 2400),
        # the 8192-point instance: 176.4 and 192 kHz (windows of 4410 and
        # 4800 samples)
        (176400.0, [176400, 90001, 4409, 4410], 176400),
        (176400.0, [4410, 6174], 6174),
        (192000.0, [192000, 100001, 4799, 4800], 192000),
        (192000.0, [4800], 4800),
        # the large instance: 352.8 and 384 kHz (windows of 8820 and 9600
        # samples, 16384 points, its workspace in shared memory) and 768 kHz
        # (19200, 32768 points, a global workspace slice a block)
        (352800.0, [352800, 180001, 8819, 8820], 352800),
        (352800.0, [8820, 12348], 12348),
        (384000.0, [384000, 200001, 9599, 9600], 384000),
        (384000.0, [9600], 9600),
        (768000.0, [768000, 19200, 26880], 768000),
    ],
)
def test_fbank_kernel_at_higher_sample_rates(dev, sample_rate, num_samples, S):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    a = fc.waveform_inputs(num_samples, S, seed=S + int(sample_rate), dev=dev, sample_rate=sample_rate)
    errs = fc.check_fbank(a, sample_rate=sample_rate)
    assert errs["log"] < fc.FBANK_LOG_TOL
    fc.check_fbank(a, num_mel_bins=40, sample_rate=sample_rate)


@pytest.mark.parametrize(
    "M,K,N,dtype",
    [
        (256, 512, 256, torch.float32),
        (1000, 200, 300, torch.float32),  # ragged: K not a multiple of 16
        (37, 2048, 129, torch.bfloat16),
        (1, 1, 1, torch.float32),
        (130, 64, 8, torch.bfloat16),
        # the three check shapes in both dtypes: the FFN's two products over
        # a serving batch's frames and the ragged one (w from a padded copy)
        (39936, 512, 2048, torch.float32),
        (39936, 2048, 512, torch.float32),
        (1000, 200, 300, torch.bfloat16),
        (39936, 512, 2048, torch.bfloat16),
        (39936, 2048, 512, torch.bfloat16),
        (301, 133, 301, torch.float32),  # K odd (scalar row pass), N * 4 not on 16 bytes
        (129, 7, 259, torch.bfloat16),
    ],
)
def test_int8_matmul_kernel_matches_plain_version_bit_exact(dev, M, K, N, dtype):
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    assert fc.check_int8_matmul(fc.int8_inputs(M, K, N, seed=M + K, dev=dev, dtype=dtype)) == 0.0


def test_front_kernels_reject_what_they_do_not_take(dev):
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.ops.quantization import int8_matmul

    wav = torch.zeros(2, 1000, device=dev)
    with pytest.raises(ValueError, match="num_samples"):
        fbank_fused(wav, torch.zeros(3, dtype=torch.int32, device=dev))
    # 22.05 kHz (a 1024-point DFT) and a window past 8192 samples (400 kHz:
    # 10000) are taken; only a framing the plain version refuses raises (40
    # Hz: a shift of 0 samples)
    from espresso_tpu_torch.ops import front_kernel_checks as fc

    a = fc.waveform_inputs([22050, 9000], 22050, seed=22, dev=dev, sample_rate=22050.0)
    assert fc.check_fbank(a, sample_rate=22050.0)["log"] < fc.FBANK_LOG_TOL
    a = fc.waveform_inputs([40000, 12000], 40000, seed=40, dev=dev, sample_rate=400000.0)
    assert fc.check_fbank(a, sample_rate=400000.0)["log"] < fc.FBANK_LOG_TOL
    with pytest.raises(ValueError, match="framing"):
        fbank_fused(wav, torch.zeros(2, dtype=torch.int32, device=dev), sample_rate=40.0)
    x = torch.zeros(4, 32, device=dev)
    w = torch.zeros(8, 32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="transposed"):
        int8_matmul(x, w.t().contiguous(), torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="w_scale"):
        int8_matmul(x, w.t(), torch.ones(7, device=dev))


# the recipe's data path on the card: a small WAV corpus (chip_smoke.
# write_corpus: 8 train and 4 valid utterances at LibriSpeech's lengths, 40
# units), the recipe's config with 2 encoder layers, the task's iterator
def _recipe(root, dev, layers=2):
    import copy
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train import trainer as tr

    cs.write_corpus(str(root), {"train": 8, "valid": 4}, units=40, seed=1)
    cfg = load_config_dict(copy.deepcopy(cs.RECIPE))
    cfg.model["encoder"] = {"encoder_layers": layers}
    cfg.dataset.data, cfg.dataset.global_cmvn_stats_path = str(root), cs.write_global_cmvn(str(root))
    task = setup_task(cfg)
    torch.manual_seed(0)
    model = task.build_model(device=dev)
    criterion = task.build_criterion()
    optimizer, _ = tr.build_optimizer(cfg)
    state = tr.create_train_state(model, optimizer, cfg)

    def groups(split):
        itr = task.get_batch_iterator(task.load_dataset(split), max_tokens=cfg.dataset.max_tokens,
                                      max_sentences=None, seed=1, shuffle=split == "train")
        return list(itr.next_epoch_itr())

    return cfg, model, criterion, optimizer, state, groups


def test_put_batch_copies_pinned_and_the_step_makes_no_host_sync(dev, tmp_path, monkeypatch):
    """put_batch stages every array in pinned memory and copies it with
    non_blocking (utt_ids and the counts stay behind); after a warm-up
    step (the front's tables reach the card once), a 2-layer train step on
    the copied batch makes no host sync."""
    from espresso_tpu_torch.cli.train import put_batch
    from espresso_tpu_torch.train.trainer import make_train_step

    cfg, model, criterion, optimizer, state, groups = _recipe(tmp_path, dev)
    group = groups("train")[0]
    copies = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if self.device.type == "cpu":
            copies.append((self.is_pinned(), kwargs.get("non_blocking", False)))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    batch = put_batch(group, dev)
    monkeypatch.setattr(torch.Tensor, "to", to)
    arrays = {k for k, v in group.items() if hasattr(v, "dtype")}
    assert set(batch) == arrays and "utt_ids" not in batch and "ntokens" not in batch
    assert copies == [(True, True)] * len(arrays)
    for k in arrays:
        assert batch[k].device.type == "cuda" and torch.equal(batch[k].cpu(), torch.from_numpy(group[k]))
    step = make_train_step(model, criterion, optimizer, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, put_batch(group, dev), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(m["loss"]).item() and m["overflow"].item() == 0.0


def test_valid_step_launches_and_matches_plain_versions(dev, tmp_path, monkeypatch):
    """A 2-layer valid step on a collated valid batch: one fbank, one
    rel_attention a layer, one rnnt_joint_lp and no train kernel; its loss
    through the plain versions (the attention, the joint, the front)
    within 1 % (chip_smoke.TRAIN_LOSS_RTOL)."""
    from espresso_tpu_torch.cli.train import put_batch
    from espresso_tpu_torch.features import fbank_kernels as fk
    from espresso_tpu_torch.modules import attention
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.train import trainer as tr

    cfg, model, criterion, _, state, groups = _recipe(tmp_path, dev)
    mb = {k: v[0] for k, v in put_batch(groups("valid")[0], dev).items()}
    valid = tr.make_valid_step(model, criterion, cfg)
    kernels = (fk.fbank_fused, ak.rel_attention, rk.rnnt_joint_lp, rk.rnnt_joint_bwd,
               ak.rel_attention_train_fwd, ak.rel_attention_train_bwd)
    before = [f.launches for f in kernels]
    loss = valid(state, mb)["loss"].item()
    counts = [f.launches - b for f, b in zip(kernels, before)]
    assert counts == [1, 2, 1, 0, 0, 0], counts
    monkeypatch.setattr(attention, "rel_attention", ak.rel_attention_reference)
    monkeypatch.setattr(rk, "rnnt_joint_lp", rk.rnnt_joint_lp_reference)
    monkeypatch.setattr(tr, "fbank_fused", fk.fbank_plain)
    plain = valid(state, mb)["loss"].item()
    assert np.isfinite(loss) and abs(loss - plain) <= 0.01 * abs(plain), (loss, plain)


@pytest.mark.parametrize("name", ["adam", "adamw", "adagrad", "adadelta", "adamax", "sgd", "nag",
                                  "momentum"])
def test_optimizer_step_on_the_card_matches_the_cpu(dev, name):
    """Two updates of each ported optimizer (weight decay 0.01, a warm-up
    schedule read from the device count) on the card and on the CPU: the
    same weights and slots to 1e-6, the same count."""
    from espresso_tpu_torch.config import EspressoConfig
    from espresso_tpu_torch.train.trainer import build_optimizer

    cfg = EspressoConfig()
    cfg.optimizer.name, cfg.optimizer.weight_decay, cfg.optimizer.momentum = name, 0.01, 0.9
    cfg.optimization.lr = [0.05]
    cfg.lr_scheduler.warmup_updates, cfg.lr_scheduler.warmup_init_lr = 2, 0.01
    g = torch.Generator().manual_seed(0)
    p, grads = torch.randn(100_003, generator=g), torch.randn(2, 100_003, generator=g) * 1e-2
    out = []
    for d in (torch.device("cpu"), dev):
        opt, _ = build_optimizer(cfg)
        params = p.clone().to(d)
        state = opt.init(params)
        for grad in grads:
            opt.step(grad.to(d), state, params, torch.tensor(True, device=d))
        out.append((params.cpu(), {k: v.cpu() for k, v in state.tensors().items()}))
    (p_cpu, s_cpu), (p_gpu, s_gpu) = out
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-6)
    assert s_cpu.keys() == s_gpu.keys() and int(s_gpu["count"]) == 2
    for k in s_cpu:
        torch.testing.assert_close(s_gpu[k], s_cpu[k], rtol=1e-5, atol=1e-6, msg=k)


def test_beam_decode_of_one_utterance_runs_the_kernels(dev):
    """The AES beam at B = 1 (the hub's one WAV, a CLI batch of one): the
    joint kernel's per-frame input is a copy (at B = 1 a reshape alone is a
    stride-0 view, which the kernel refused); the utterance's top-1 score
    within 1 % of the same decode through the plain versions."""
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode import transducer_beam

    model = _small_model(dev)
    g = torch.Generator().manual_seed(3)
    batch = {"src_frames": torch.randn(1, 160, 80, generator=g).to(dev, torch.bfloat16),
             "src_lengths": torch.tensor([160], device=dev)}
    beam = dict(beam_size=4, expansion_beta=2, expansion_gamma=2.3)
    dic = AsrDictionary(enable_bos=True)
    before = dk.fused_joint_topk.launches
    got = transducer_beam.TransducerBeamSearchDecoder(model, dic, **beam).decode(batch)
    assert dk.fused_joint_topk.launches > before and len(got) == 1 and len(got[0]) == 4
    plain = [(transducer_beam, f.__name__, getattr(dk, f.__name__ + "_reference")) for f in dk.KERNELS]
    saved = [(m, n, getattr(m, n)) for m, n, _ in plain]
    try:
        for m, n, fn in plain:
            setattr(m, n, fn)
        want = transducer_beam.TransducerBeamSearchDecoder(model, dic, **beam).decode(batch)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    assert abs(got[0][0]["score"] - want[0][0]["score"]) <= 0.01 * abs(want[0][0]["score"])


def _speech_lstm(seed, **over):
    """A small attention encoder-decoder (a 2-layer frontend, a 2-layer
    bi-LSTM of 32, a 2-layer decoder of 32, Bahdanau attention 16, V = 61,
    dropout 0) from a seeded init, its output layer x4 (no greedy or beam
    near-ties), and seeded frames, targets and lengths."""
    from espresso_tpu_torch.models.speech_lstm import SpeechLSTMConfig, SpeechLSTMModel

    torch.manual_seed(seed)
    cfg = SpeechLSTMConfig(feat_dim=16, vocab_size=61, conv_channels=(4, 8),
                           conv_kernel_sizes=((3, 3), (3, 3)), conv_strides=((2, 2), (2, 2)),
                           encoder_hidden_size=32, encoder_layers=2, decoder_embed_dim=12,
                           decoder_hidden_size=32, decoder_out_embed_dim=40, decoder_layers=2,
                           attention_dim=16, dropout=0.0, **over)
    model = SpeechLSTMModel(cfg)
    with torch.no_grad():
        model.decoder.fc_out.weight.mul_(4.0)
    g = torch.Generator().manual_seed(seed)
    frames = torch.randn(3, 60, 16, generator=g)
    lengths = torch.tensor([60, 45, 23])
    target = torch.randint(3, 61, (3, 7), generator=g)
    target[1, 5:], target[2, 3:] = 1, 1
    target[0, 6], target[1, 4], target[2, 2] = 2, 2, 2
    prev = torch.cat([torch.full((3, 1), 2), target[:, :-1]], 1)
    return model, frames, lengths, target, prev


def test_speech_lstm_train_step_on_the_card_matches_the_cpu(dev):
    """One fp32 train step of the attention encoder-decoder (label-smoothed
    CE, adam, clip 0.5, scheduled sampling off) on the card and on the CPU
    from one init: the loss and gradient norm to 1e-5 relative, every
    weight to 1e-5 (cuDNN's LSTM beside ATen's loop)."""
    import copy

    from espresso_tpu_torch.config import EspressoConfig
    from espresso_tpu_torch.criterions import build_criterion
    from espresso_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False  # cuDNN's LSTM in full fp32, as on the CPU
    cfg = EspressoConfig()
    cfg.common.dtype, cfg.criterion.label_smoothing = "float32", 0.1
    cfg.optimization.clip_norm, cfg.optimization.lr, cfg.optimizer.adam_eps = 0.5, [0.01], 1e-4
    model, frames, lengths, target, prev = _speech_lstm(1)
    batch = {"src_frames": frames, "src_lengths": lengths, "target": target, "prev_output_tokens": prev,
             "tgt_lengths": (target != 1).sum(1), "weight": torch.ones(3)}
    task = type("T", (), {"dictionary": type("D", (), {"pad": lambda self: 1, "count": [1] * 61})()})()
    out = []
    for d in (torch.device("cpu"), dev):
        m = copy.deepcopy(model).to(d)
        opt, _ = trainer.build_optimizer(cfg)
        state = trainer.create_train_state(m, opt, cfg)
        step = trainer.make_train_step(m, build_criterion(cfg.criterion, task), opt, cfg)
        state, metrics = step(state, {k: v[None].to(d) for k, v in batch.items()},
                              torch.Generator(device=d).manual_seed(0))
        out.append(({k: metrics[k].item() for k in ("loss", "gnorm")}, state.params.cpu()))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-5 * abs(m_cpu[k]), (k, m_gpu[k], m_cpu[k])
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-5)


def test_speech_lstm_beam_with_lm_on_the_card_matches_the_cpu(dev):
    """The beam search (K = 5, eos_factor 1.5, lenpen 0.6) fused with an
    LSTM LM at 0.47, fp32, on the card and on the CPU: the same n-best
    tokens, scores to 1e-4 relative; the card's loop makes no host sync."""
    from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig

    torch.backends.cudnn.allow_tf32 = False  # cuDNN's LSTM in full fp32, as on the CPU
    model, frames, lengths, _, _ = _speech_lstm(2)
    torch.manual_seed(3)
    lm = LSTMLanguageModel(LSTMLMConfig(vocab_size=61, embed_dim=16, hidden_size=24, out_embed_dim=24,
                                        num_layers=2, dropout=0.0))
    dic = type("D", (), {"eos": lambda self: 2, "pad": lambda self: 1})()
    out = []
    for d in (torch.device("cpu"), dev):
        dec = BeamSearchDecoder(model.to(d).eval(), dic, beam_size=5, max_len_b=15, eos_factor=1.5,
                                len_penalty=0.6, lm=lm.to(d).eval(), lm_weight=0.47)
        batch = {"src_frames": frames.to(d), "src_lengths": lengths.to(d)}
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                handle = dec.decode_async(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out.append(dec.collect(handle))
        else:
            out.append(dec.decode(batch))
    for want, got in zip(*out):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            assert abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"])


def _speech_transformer(seed, **over):
    """A small transformer encoder-decoder (a 2-layer frontend, 2 encoder
    layers with relative positions and 2 decoder layers of 128, 2 heads of
    64, V = 61, dropout 0) from a seeded init, and seeded frames and
    lengths."""
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig, SpeechTransformerModel

    torch.manual_seed(seed)
    kw = dict(feat_dim=16, vocab_size=61, conv_channels=(4, 8), conv_kernel_sizes=((3, 3), (3, 3)),
              conv_strides=((2, 2), (2, 2)), encoder_embed_dim=128, encoder_ffn_dim=256, encoder_layers=2,
              encoder_heads=2, decoder_embed_dim=128, decoder_ffn_dim=256, decoder_layers=2,
              decoder_heads=2, dropout=0.0, encoder_pos_type="relative")
    model = SpeechTransformerModel(SpeechTransformerConfig(**{**kw, **over}))
    g = torch.Generator().manual_seed(seed)
    return model, torch.randn(3, 80, 16, generator=g), torch.tensor([80, 61, 23])


def test_speech_transformer_encoder_runs_the_attention_kernels(dev):
    """The transformer encoder's relative self-attention on the card in
    bf16: one B1 launch a layer in eval, the output within 0.05 (a few bf16
    ulps after two layers) of the same encoder through the plain version;
    one B2 and one B3 launch a layer in a train step's forward and
    backward."""
    from espresso_tpu_torch.modules import attention
    from espresso_tpu_torch.ops import attention_kernels as ak

    model, frames, lengths = _speech_transformer(4)
    model = model.to(dev, torch.bfloat16).eval()
    x, n = frames.to(dev, torch.bfloat16), lengths.to(dev)
    before = ak.rel_attention.launches
    with torch.no_grad():
        got = model.encode(x, n)
    torch.cuda.synchronize()
    assert ak.rel_attention.launches == before + 2
    attention.rel_attention, kernel = ak.rel_attention_reference, attention.rel_attention
    try:
        with torch.no_grad():
            want = model.encode(x, n)
    finally:
        attention.rel_attention = kernel
    valid = got.encoder_padding_mask[..., None]
    err = ((got.encoder_out.float() - want.encoder_out.float()) * valid).abs().max().item()
    assert err <= 0.05, err
    fwd, bwd = ak.rel_attention_train_fwd.launches, ak.rel_attention_train_bwd.launches
    model.train()
    model.encode(x, n).encoder_out.float().sum().backward()
    torch.cuda.synchronize()
    assert (ak.rel_attention_train_fwd.launches - fwd, ak.rel_attention_train_bwd.launches - bwd) == (2, 2)


def test_speech_transformer_beam_with_lm_on_the_card_matches_the_cpu(dev):
    """The transformer with absolute positions (no kernel: the relative
    attention's take bf16 alone) through the beam search (K = 5,
    eos_factor 1.5, lenpen 0.6) fused with an LSTM LM at 0.4, fp32, on the
    card and on the CPU: the same n-best tokens, scores to 1e-4 relative;
    the card's loop (its caches written in place, reordered by gathers)
    makes no host sync."""
    from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig

    model, frames, lengths = _speech_transformer(5, encoder_pos_type="abs",
                                                 share_decoder_input_output_embed=False)
    with torch.no_grad():
        model.fc_out.weight.mul_(4.0)
    torch.manual_seed(6)
    lm = LSTMLanguageModel(LSTMLMConfig(vocab_size=61, embed_dim=16, hidden_size=24, out_embed_dim=24,
                                        num_layers=2, dropout=0.0))
    dic = type("D", (), {"eos": lambda self: 2, "pad": lambda self: 1})()
    out = []
    for d in (torch.device("cpu"), dev):
        dec = BeamSearchDecoder(model.to(d).eval(), dic, beam_size=5, max_len_b=15, eos_factor=1.5,
                                len_penalty=0.6, lm=lm.to(d).eval(), lm_weight=0.4)
        batch = {"src_frames": frames.to(d), "src_lengths": lengths.to(d)}
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                handle = dec.decode_async(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out.append(dec.collect(handle))
        else:
            out.append(dec.decode(batch))
    for want, got in zip(*out):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            assert abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"])
    assert max(len(h[0]["tokens"]) for h in out[0]) > 1


def _ctc_model(seed, **over):
    """A small transformer CTC model (a 2-layer frontend, 2 encoder layers
    of 128, 2 heads of 64, V = 61, dropout 0) from a seeded init, and
    seeded frames, lengths and targets."""
    from espresso_tpu_torch.models.encoder_models import (
        SpeechTransformerEncoderModel,
        TransformerEncoderModelConfig,
    )
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig

    torch.manual_seed(seed)
    enc = dict(conv_channels=(4, 8), conv_kernel_sizes=((3, 3), (3, 3)), conv_strides=((2, 2), (2, 2)),
               encoder_embed_dim=128, encoder_ffn_dim=256, encoder_layers=2, encoder_heads=2, dropout=0.0,
               encoder_pos_type="relative")
    model = SpeechTransformerEncoderModel(TransformerEncoderModelConfig(
        feat_dim=16, vocab_size=61, encoder=SpeechTransformerConfig(**{**enc, **over})))
    g = torch.Generator().manual_seed(seed)
    targets = torch.randint(3, 61, (3, 12), generator=g)
    return (model, torch.randn(3, 120, 16, generator=g), torch.tensor([120, 95, 40]), targets,
            torch.tensor([12, 9, 4]))


def test_ctc_loss_on_the_card_repeats_bit_for_bit_and_matches_the_cpu(dev):
    """The CTC loss and its gradient at the recipe's sizes (T' = 300, V =
    5,004, targets of up to 90 labels, repeats among them) on the card:
    twice bit for bit (the gradient onto the vocabulary by a one-hot
    product, no scatter-add), and within the CPU's: the losses to 1e-5,
    the gradient to 1e-4 of its largest (the recursion sums log-probs to
    ~2,500, where f32's spacing is 2.4e-4: the posteriors exp(alpha + beta
    - ll) carry that error; 1.1e-5 measured on an H100)."""
    from espresso_tpu_torch.ops.ctc import ctc_loss

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 300, 5004, generator=g)
    targets = torch.randint(1, 5004, (6, 90), generator=g)
    targets[:, 1::7] = targets[:, ::7][:, : targets[:, 1::7].shape[1]]
    lens, tlens = torch.tensor([300, 280, 250, 200, 150, 100]), torch.tensor([90, 80, 70, 60, 40, 30])
    out = []
    for d in (dev, dev, torch.device("cpu")):
        x = logits.to(d).requires_grad_()
        loss = ctc_loss(x, lens.to(d), targets.to(d), tlens.to(d), blank=0)
        loss.sum().backward()
        out.append((loss.detach().cpu(), x.grad.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    torch.testing.assert_close(out[0][0], out[2][0], rtol=1e-5, atol=0)
    assert (out[0][1] - out[2][1]).abs().max() <= 1e-4 * out[2][1].abs().max()


def test_ctc_model_gradients_on_the_card_match_the_cpu(dev):
    """The CTC criterion on the small model with absolute positions (no
    kernel: the relative attention's take bf16 alone), fp32, train mode at
    dropout 0, on the card and on the CPU: the loss to 1e-5 and every
    gradient to 1e-4 of the largest, relative."""
    from espresso_tpu_torch.config import CriterionSection
    from espresso_tpu_torch.criterions import CTCCriterion

    model, frames, lengths, targets, tlens = _ctc_model(7, encoder_pos_type="abs")
    dic = type("D", (), {"eos": lambda self: 2, "pad": lambda self: 1, "blank": lambda self: 0})()
    crit = CTCCriterion(CriterionSection(name="ctc_loss"), dic)
    out = []
    for d in (torch.device("cpu"), dev):
        m = model.to(d).train()
        m.zero_grad()
        batch = {"src_frames": frames.to(d), "src_lengths": lengths.to(d), "target": targets.to(d),
                 "tgt_lengths": tlens.to(d), "weight": torch.ones(3, device=d)}
        loss, _, _ = crit(m, batch)
        loss.backward()
        out.append((loss.item(), [p.grad.cpu().clone() for p in m.parameters()]))
    (want, wg), (got, gg) = out
    assert abs(got - want) <= 1e-5 * abs(want)
    scale = max(w.abs().max() for w in wg)
    for w, x in zip(wg, gg):
        assert (w - x).abs().max() <= 1e-4 * scale


def test_ctc_prefix_beam_on_the_card_matches_the_cpu(dev):
    """The relative-position model in bf16 on the card launches B1 a layer
    in the prefix beam's device part without a host sync; the model with
    absolute positions in fp32 (its output layer x20, so that ~10 tokens a
    frame pass the search's pruning) on the card and on the CPU: the same
    n-best tokens rank by rank, scores to 1e-4 relative."""
    from espresso_tpu_torch.decode.ctc_decoder import CTCPrefixBeamSearchDecoder
    from espresso_tpu_torch.ops import attention_kernels as ak

    dic = type("D", (), {"blank": lambda self: 0})()
    model, frames, lengths, _, _ = _ctc_model(8)
    dec = CTCPrefixBeamSearchDecoder(model.to(dev, torch.bfloat16).eval(), dic, beam_size=10)
    before = ak.rel_attention.launches
    batch = {"src_frames": frames.to(dev), "src_lengths": lengths.to(dev)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = dec.decode_async(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ak.rel_attention.launches == before + 2 and len(dec.collect(handle)) == 3
    model, frames, lengths, _, _ = _ctc_model(9, encoder_pos_type="abs")
    with torch.no_grad():
        model.fc_out.weight.mul_(20.0 * 3 ** 0.5)
    out = []
    for d in (torch.device("cpu"), dev):
        dec = CTCPrefixBeamSearchDecoder(model.to(d).eval(), dic, beam_size=10)
        out.append(dec.decode({"src_frames": frames.to(d), "src_lengths": lengths.to(d)}))
    for want, got in zip(*out):
        assert [list(h["tokens"]) for h in got] == [list(h["tokens"]) for h in want]
        for w, g in zip(want, got):
            assert abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"])
    assert min(len(h[0]["tokens"]) for h in out[0]) > 1
