"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving paths and its train path
(``espresso_tpu_torch``) at the flagship Conformer-Transducer's full width,
fed frames and fed PCM through the on-device feature front, and checks its
eleven Hopper kernels:

1. requires a CUDA card of capability (9, 0); builds every kernel from
   ``espresso_tpu_torch/csrc`` with nvcc (sm_90a), one nvcc process per
   library, all at once, and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   flagship shapes and at edge shapes (``rel_attention`` in bf16 with
   ragged key masks; ``fused_joint_topk`` at V=1024, 5003, 1032 and 67,
   J=128, 512 and 640, n=1 to 32, BK=2550, with eos folding and an LM label
   bias; ``lstm_step_reorder`` at BK=1, 12, 2550 and 2560, H=64 to 1024,
   L=1 to 3, every row dead or live; ``aes_merge`` at K=1 to 20 with
   dead slots, duplicate hashes, ties, all-NEG_INF rows and one live
   column, with the blank add folded in (bit for bit the call on the
   pre-added scores) and without; ``aes_backtrace`` bit for bit, at T'=1
   to 1024 and K=1 to 33 with indices outside [0, K), inactive frames and
   slots from-pool through every merge round; the train kernels
   ``rel_attention_train_fwd``/``_bwd`` at B=16, T'=256, at B=40 and at
   odd or short shapes (T'=1 included) with ragged key masks, at dropout 0
   and 0.1 with one seed, and the forward alone at its tiling edges up to
   T'=1408; ``rnnt_joint_lp``/``_bwd`` at B=16, T'=256,
   U1=101, J=512, V=1024 and V=5003 with the blank in a later tile, ragged
   lengths, T'=1 and U=0; ``fbank`` at
   the 256-utterance serving batch as PCM and at edge sample counts (399,
   400, one window short, one utterance) by the Kaldi goldens' rule, and
   timed at the PCM-fed train point too;
   ``int8_matmul`` at the flagship FFN shapes over a serving batch's frames
   and a ragged one, bit for bit; ``lstm_step_reorder`` also at the
   ``beam_lm`` point's LM, embed 512 gate-padded to H=1024, L=3, at BK=2560
   and 12; ``fbank`` also at 22.05, 44.1 (an odd shift), 48, 96, 176.4,
   192, 352.8 and 384 kHz, the 1024- to 8192-point instances and the large
   instance, at edge counts and at a batch of the serving batch's audio
   seconds), and times kernel and plain version at
   the flagship shape (and, beside B5, B6 and B7, their products alone
   through cuBLAS as a yardstick, beside B1 the forward of
   ``scaled_dot_product_attention``, beside B2 its forward with dropout,
   beside B3 its backward, beside B10 cuFFT's ``rfft`` of the
   valid frames alone; for B3 and B5 also every kernel the call runs and
   the split by kernel; for B8 the wrapper's host time a call);
3. builds the flagship model (16 conformer layers, d=512, ffn 2048, 8 heads,
   depthwise kernel 31, relative positions, batch norm; 2x512 LSTM
   prediction net, joint 512, V=1024) from a seeded init in bf16, and
   decodes B=256 utterances of T=624 frames greedily, then with the AES
   beam decoder at ``bench.py``'s operating point (beam 10, beta 2, gamma
   2.3, 2 expansions per frame, max_out_factor 0.35, prefix_alpha 1, no
   LM): one warm-up batch, then three launched back to back, with every
   kernel's launch count set to 0 just before and read just after each
   path, and asserted;
4. checks the outputs: well-formed hypotheses (finite, sorted, in the
   vocab, within the length cap); the encoder output on a sub-batch against
   the plain attention; and the beam decode of an 8-utterance sub-batch
   with the joint peaked x6 through the kernels against the same decode
   through the plain versions; then decodes the same batch from PCM:
   ``make_device_feature_fn`` (fbank, global CMVN from stats the port
   accumulates from the batch) before the beam decoder, one warm-up and
   one timed batch, one ``fbank`` launch a batch and every other kernel
   launched as often as in a frame-fed batch, no host sync in the front,
   and the front's share of the batch;
5. decodes the serving batch at ``bench_decode.py``'s ``beam_lm`` point
   (:212-239): the same beam search fused with an LSTM LM of 3 layers,
   hidden 1024, embed 512, out_embed 512, V_lm = 1023 (seeded init, bf16)
   at lm_weight 0.47: one warm-up and three timed batches with the launch
   counts asserted (B6 and B8 three times a frame, B7 twice a frame for
   the prediction net and twice for the LM, B9 once), a profiled batch,
   and an 8-utterance sub-batch (joint peaked x6, the LM as built)
   through the kernels against the plain versions (top-1 scores within
   1 %); times B7's LM instance alone beside its bound and cuBLAS on its
   products;
6. trains the flagship from a seeded init at ``bench_train.py``'s point
   (B=16 utterances of 1024 frames, U=100, dropout 0.1, bf16 compute on
   fp32 masters, adam at a fixed lr of 1e-3, clip 2.0): one warm-up step,
   then 10 steps on one batch with every kernel's count set to 0 just
   before, asserting 16 launches of each attention kernel and one of each
   joint kernel per step, finite losses, no skipped update and a falling
   loss; profiles one step; and holds one step of a 2-utterance sub-batch
   at dropout 0 through the kernels against the same step through the
   plain versions; then trains from PCM (B=16, S=164,080) with the
   recipe's front (fbank, global CMVN, SpecAugment with time warp W=80):
   a warm-up step and 3 steps, one ``fbank`` launch a step, no host sync in
   the front and the SpecAugment draws, and two steps with quant noise
   p=0.1 (~0.1 of the noised leaves' 8-blocks zeroed, the fp32 masters
   never noised);
7. trains the recipe from a WAV manifest (``run_recipe_data_path``): a
   seeded corpus of 128 train and 32 valid 16 kHz utterances at
   LibriSpeech train-clean's lengths with a 5,000-unit vocabulary, global
   CMVN from its train split; ``conformer_transducer_librispeech.yaml``
   (``RECIPE``) through ``load_config_dict`` with two spawn-process
   collate workers; ``setup_task`` -> ``build_model`` (16 layers) ->
   ``get_batch_iterator`` (T x U buckets, max_tokens 590000) ->
   ``put_batch`` -> ``make_train_step`` for one epoch (launch counts,
   finite losses, no skipped update, no host sync in a step), a valid pass
   through ``make_valid_step`` (B10, B1, B4 only; one batch against the
   plain versions), and the spawn workers' first batches against an
   in-process iterator's, bit for bit; prints the loader's wait share,
   collate, copy, step and valid times;
8. runs the recipe through the port's entry points (``run_recipe_clis``,
   run.sh's stages): ``prep asr_prep_json`` and ``text2vocabulary`` over a
   seeded 48 + 16 utterance WAV corpus (V = 5,004), ``cli.train.main`` for
   2 epochs at the flagship width with WER validation, SIGTERM raised
   after the first update of epoch 2 and a second ``main`` resuming from
   checkpoint_last (asynchronous checkpoint writes), ``average_checkpoints
   --num-epoch-checkpoints 2``, ``speech_recognize`` from checkpoint_avg at
   beam 10 and again fused with an LSTM LM written by the port's
   checkpoint module, and the hub's ``transcribe`` against the CLI's
   hypotheses; every kernel's launches per step, valid batch and decode
   batch asserted; prints the ``recipe_cli`` JSON line;
9. encodes and trains 2 layers of the flagship on utterances past its
   relative table (T' = 1500).

Any failure raises (nonzero exit) before the result lines. Prints the
serving and ``{"train": ...}`` JSON lines, then, as its last three lines,
the kernel summary JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Exits nonzero without a result when
no CUDA card is present.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = dict(B=256, T_FRAMES=624, FEAT=80, VOCAB=1024)
BEAM = dict(
    beam_size=10, expansion_beta=2, expansion_gamma=2.3, max_num_expansions_per_step=2,
    max_out_factor=0.35, prefix_alpha=1,
)
# (B, T') at H=8, d=64: the flagship, then B1's tiling edges (64-row query
# and key tiles, scores in registers up to three key tiles and in shared
# memory past them, up to the longest T' it takes)
ATTN_SHAPES = [(256, 156), (4, 2), (4, 37), (2, 1024), (3, 1), (3, 63), (3, 64), (3, 65),
               (3, 129), (3, 200), (2, 1344)]
# the long-row mode of B1 (T' past 1344: no score row in shared memory) at
# two heads (the plain version gathers a [T, T, H, d] position table: 17 GB
# at T' = 4096 and eight heads), ragged key masks; timed at 4 utterances of
# T' = 1500 (60 s of audio) and eight heads
ATTN_LONG_SHAPES = [(3, 1345), (2, 1500), (2, 2048), (1, 4096)]
ATTN_LONG_TIMED = (4, 1500)
# a layer past its relative table (encoder_relative_max_size L < T'): the
# port expands the table and runs the kernels (T', L)
CLIPPED_LAYER = (300, 64)
# B6's edge shapes beside the flagship: (B, K, V, J = H, n, fold eos, label bias)
JOINT_EDGES = [
    (256, 10, 5003, 512, 12, False, False), (4, 4, 5003, 512, 6, True, True),
    (1, 1, 1024, 512, 3, False, True), (3, 4, 67, 512, 6, True, False),
    (255, 10, 1024, 512, 12, False, False), (255, 10, 1032, 640, 32, True, True),
    (8, 4, 1032, 128, 32, False, True), (8, 4, 1024, 640, 1, True, False),
    (3, 4, 67, 128, 1, False, True),
]
# B6's wide instance (J or H above 1024): (B, K, V, J, H, n, fold eos, label
# bias); timed at the flagship's beam batch with J = H = 2048
JOINT_WIDE = [
    (256, 10, 1024, 1088, 1088, 12, False, False), (256, 10, 5003, 2048, 2048, 12, False, False),
    (255, 10, 1024, 2048, 2048, 32, True, True), (8, 4, 5003, 1088, 1088, 12, False, True),
    (3, 4, 1032, 2048, 512, 1, True, False), (5, 4, 1024, 512, 2048, 16, False, True),
]
JOINT_WIDE_TIMED = 2048
# bench_decode.py's beam_lm point (:212-239): BEAM with an LSTM LM
LM = dict(vocab_size=1023, embed_dim=512, hidden_size=1024, out_embed_dim=512, num_layers=3,
          dropout=0.0)
LM_WEIGHT = 0.47
# B7's: (B, K, H, L, share of live rows)
LSTM_EDGES = [
    (1, 1, 512, 2, 0.8), (3, 4, 512, 3, 0.8), (1, 12, 512, 2, 0.8), (255, 10, 512, 2, 0.8),
    (3, 4, 64, 1, 0.8), (2, 6, 1024, 3, 0.8), (255, 10, 512, 2, 0.0), (4, 3, 512, 2, 1.0),
]
H, D = 8, 512
FRAME_SHIFT_S = 0.01
# the encoder output after 16 bf16 layers, kernel vs plain attention: each
# layer may flip the bf16 rounding of a few scores, which the residual stream
# carries on; the final LayerNorm output is O(1), so 0.25 is ~16 bf16 ulps at
# magnitude 2-4 and far below the O(1) error of a wrong kernel
ENCODER_ATOL = 0.25
# the top-1 beam score of a sub-batch utterance, kernels vs plain versions,
# relative to its magnitude: the two paths round the bf16 encoder (outputs
# apart by up to ENCODER_ATOL), joint hidden and prediction-net state at the
# same points but sum in other orders, and the x6 peaked joint turns each
# difference into a log-prob difference proportional to the log-probs
# themselves; 1 % bounds that drift, while a wrong kernel moves the
# log-probs by their own size
BEAM_SCORE_RTOL = 0.01
# the train path: bench_train.py:59-140's operating point
TRAIN = dict(B=16, T_FRAMES=1024, U=100, STEPS=10, DROPOUT=0.1)
# (B, T') at H=8, d=64: the flagship, short and odd lengths (T'=1: one key,
# ds exactly 0), and B=40 (dp summed over more utterances than at the
# flagship)
ATTN_TRAIN_SHAPES = [(16, 256), (3, 1), (3, 2), (3, 37), (40, 64)]
# the train forward's tiling edges beside them (64-row query and key tiles,
# scores and e in registers for three key tiles, shared score rows
# past them, up to the longest T' it takes), the last utterance with one
# valid key: the forward alone, at dropout 0 and 0.1
ATTN_TRAIN_FWD_EDGES = [(3, 63), (3, 64), (3, 65), (3, 129), (3, 192), (3, 193), (2, 1408)]
# the forward's long-row mode (past T' = 1408) and the backward at the same
# lengths, rates 0 and 0.1; timed at 2 utterances of T' = 2048
ATTN_TRAIN_LONG_SHAPES = [(2, 1409), (2, 1500), (1, 2048), (1, 4096)]
ATTN_TRAIN_LONG_TIMED = (2, 2048)
# long utterances past the flagship's relative table (1024): the flagship's
# width at two layers, B=2 utterances of 6000 frames (T' = 1500, 60 s, the
# data config's max_source_positions), an encoder pass and a train step
LONG_UTT = dict(B=2, T_FRAMES=6000, LAYERS=2, U=100)
# (B, T', U, V, blank): the flagship, V=5003 with the blank in the third
# 64-column tile, a small ragged edge, T'=1, and U=0 (U1=1); then V=67 and
# V=5003 with the blank in the last column, an odd number of 64-row tiles
# (B4 pairs them), and T'=1 with U=0
RNNT_SHAPES = [(16, 256, 100, 1024, 0), (16, 256, 100, 5003, 131), (3, 37, 9, 5003, 4999),
               (2, 1, 5, 1024, 0), (2, 9, 0, 1024, 0), (3, 19, 6, 67, 66),
               (2, 23, 11, 5003, 5002), (3, 17, 4, 1024, 3), (1, 1, 0, 5003, 5002)]
# one train step of a 2-utterance sub-batch at dropout 0, kernels vs plain
# versions: both round every bf16 activation at the same points but sum in
# other orders, and a rounding flip in one of 16 layers moves the loss by
# bf16 noise, ~1e-3 relative; 1 % bounds that, while a wrong kernel moves
# the loss and the gradient by their own size. Each parameter's gradient is
# held on its own, except those that are 0 in exact arithmetic and hold
# rounding noise only: the biases that feed a batch norm (the frontend's
# convolutions, the depthwise convolutions) and the key bias, which adds a
# constant to each row of scores under the softmax. Two measures per leaf:
# ||g - g_plain|| / ||g_plain||, and the share of g_plain that g is off along
# g_plain, |<g - g_plain, g_plain>| / ||g_plain||^2, which rounding noise
# barely moves and a wrong scale moves by all of its error. On an H100 the
# sound kernels read at most 0.087 and 0.013 over the 593 leaves (median
# 0.005); dp, dq_v or g_b made 10 % too small read 0.10-0.11 on the second
# measure, and dp rolled by one position 0.27 on the first. The bounds sit
# at about twice and three times the sound readings.
TRAIN_LOSS_RTOL = 0.01
TRAIN_GNORM_RTOL = 0.05
TRAIN_LEAF_GRAD_REL = 0.2
TRAIN_LEAF_SCALE = 0.04
TRAIN_ZERO_GRAD = re.compile(r"(conv\.convs\.\d+|depthwise_conv|self_attn\.k_proj)\.bias$")
# the feature front: the flagship recipe's SpecAugment
# (conformer_transducer_librispeech.yaml:35) and the train point's waveform
# length, (1024 - 1) * 160 + 400 samples, as the JAX collator pads it
SPECAUGMENT = "{'W': 80, 'F': 27, 'T': 100, 'num_freq_masks': 2, 'num_time_masks': 2, 'p': 1.0}"
# the recipe data path's corpus: utterance lengths of LibriSpeech
# train-clean (a normal around 12.5 s, sd 3.5 s, clipped to 1.5-24.5 s),
# 16 kHz 16-bit mono WAV, ~3.5 units a second (at least 1) from the
# reference LibriSpeech recipe's 5,000-unit vocabulary
CORPUS = dict(TRAIN=128, VALID=32, MEAN_S=12.5, SD_S=3.5, MIN_S=1.5, MAX_S=24.5,
              UNITS_PER_S=3.5, UNITS=5000, RATE=16000)
# the flagship recipe, examples/asr_librispeech/conformer_transducer_librispeech.yaml,
# written out (the card machine is not known to have PyYAML;
# tests/test_torch_data.py holds the two equal)
RECIPE = {
    "common": {"dtype": "bfloat16", "log_interval": 100},
    "task": {"name": "speech_recognition_espresso"},
    "criterion": {"name": "transducer_loss"},
    "model": {"name": "conformer_transducer_librispeech"},
    "dataset": {
        "feat_dim": 80, "feature_type": "device_fbank", "max_tokens": 590000,
        "batch_based_on_both_src_tgt": True, "num_batch_buckets": 10,
        "required_batch_size_multiple": 8, "specaugment_config": SPECAUGMENT,
    },
    "optimizer": {"name": "adam", "adam_betas": [0.9, 0.98]},
    "lr_scheduler": {"name": "noam", "warmup_updates": 12000, "model_size": 512},
    "optimization": {"lr": [5.0], "clip_norm": 10.0, "max_epoch": 120, "update_freq": [1]},
    "checkpoint": {"save_dir": "ckpts_conformer_transducer", "best_checkpoint_metric": "wer",
                   "keep_last_epochs": 10},
}
SHIFT, WINDOW = 160, 400
QUANT_NOISE_P = 0.1
# B8's (B, K): the flagship, then one column, one beam, 16 beams (32
# columns, a lane each), 20 beams (40 columns: lanes take two)
MERGE_SHAPES = [(256, 10), (1, 1), (1, 4), (5, 16), (5, 20)]
# B9's edges beside the flagship: (T', K) from one frame to more than one
# chunk of staged frames and from one beam to past a warp of walkers, each
# at B=5 with order/msrc/esrc entries outside [0, K), inactive frames inside
# a length and slots from-pool through every merge round
BACKTRACE_EDGES = [(T, K) for T in (1, 37, 156, 1024) for K in (1, 4, 10, 20, 33)]
# B10's edge sample counts and lengths (n, S): under one window, exactly
# one, S not a multiple of the shift, S odd, B = 1, the PCM-fed train point
FBANK_EDGES = [([399, 400, 16000], 16000), ([250], 250), ([4321], 4321),
               ([16161, 401, 9999], 16161), ([400], 400), ([164080] * 16, 164080)]
# B10 at 8 kHz (window 200, shift 80: a 256-point DFT), and the serving
# batch's frame counts at 8 kHz
FBANK_8K = [([8200, 4500, 150], 8200), ([201], 201), ([4321], 4321)]
SHIFT_8K, WINDOW_8K = 80, 200
# B10's larger instances: (sample rate, edge counts and S), each also timed
# at the serving batch's frame counts (S = (T - 1) shift + window)
FBANK_RATES = [
    (22050.0, [([22050, 12000, 540], 22050), ([551], 551)]),
    (44100.0, [([44100, 30001, 1101], 44100), ([1102, 1543], 1543)]),
    (48000.0, [([48000, 31111, 1199], 48000)]),
    (96000.0, [([96000, 50001, 2399], 96000), ([2400], 2400)]),
    (176400.0, [([176400, 90001, 4409], 176400), ([4410, 6174], 6174)]),
    (192000.0, [([192000, 100001, 4799], 192000), ([4800], 4800)]),
    # the large instance (16384 points): windows of 8820 and 9600 samples
    (352800.0, [([352800, 180001, 8819], 352800), ([8820, 12348], 12348)]),
    (384000.0, [([384000, 200001, 9599], 384000), ([9600], 9600)]),
]
# the large instance's timing at the serving batch's audio seconds: ~90 ms
# a kernel call and ~1 s a plain one (a 16384-point DFT by matmuls): (kernel
# calls a trace, event samples of 10 calls, plain calls)
FBANK_LARGE_TIMING = {352800.0: (5, 3, 2), 384000.0: (5, 3, 2)}
# B11's shapes: the flagship FFN's two products over a serving batch's
# encoder frames (256 x 156), and a ragged edge
INT8_SHAPES = [(39936, 512, 2048), (39936, 2048, 512), (1000, 200, 300)]
# the card's published peaks (H100 SXM data sheet, dense): bf16 tensor
# cores, int8 tensor cores, fp32 outside them, device memory
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bound(n_bytes: float, flops: float, peak_flops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(fn, samples: int = 20, reps: int = 10) -> float:
    """Median over ``samples`` of the device time per call of ``reps`` calls
    enqueued back to back, so that the host's launch gap before the first
    call is spread over ``reps`` instead of counted in every sample."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, calls: int = 20, kernel: str = "", per_call=None) -> float:
    """Device time per call of ``fn`` from a ``torch.profiler`` trace of
    ``calls`` calls: the time of the CUDA kernels whose name contains
    ``kernel`` (or of every kernel, when it is empty), without the host's
    launch gaps. The tracer can drop kernel records: a trace that holds no
    device time or, with ``per_call`` (the kernels one call launches),
    fewer launches than that is taken again, up to three times; then the
    time a call comes from the launches the last such trace recorded, if it
    holds at least half of them, and else from CUDA events of back-to-back
    calls (launch gaps included), as the log says."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    recorded = None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        total_us = sum(e.self_device_time_total for e in events)
        launched = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
        if total_us > 0 and (per_call is None or launched >= calls * per_call):
            return total_us / calls / 1e3
        log(f"profiler trace {attempt} of {kernel or fn}: {launched} kernel launches of "
            f"{calls * (per_call or 0)}, {total_us} us")
        if total_us > 0 and per_call and 2 * launched >= calls * per_call:
            recorded = total_us / launched * per_call / 1e3
    if recorded is not None:
        log(f"{kernel or fn}: the profiler dropped launches three times; the launches it "
            f"recorded give {recorded} ms a call")
        return recorded
    ms = median_ms(fn)
    log(f"{kernel or fn}: the profiler missed launches three times; CUDA events give {ms} ms")
    return ms


def device_split(fn, calls: int = 10, per_launch: bool = False) -> dict:
    """Device ms per call of ``fn`` by CUDA kernel name (every kernel the
    call runs, its launches included), from one ``torch.profiler`` trace;
    with ``per_launch``, the mean ms of one launch of each kernel instead,
    which a trace that dropped some launches' records does not bias."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / (e.count if per_launch else calls) / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def rnnt_bwd_cublas_ms(B: int, T: int, U1: int, J: int, V: int, dev) -> float:
    """A yardstick for B5, not a library call for its function: its three
    products alone through cuBLAS on a materialised bf16 joint hidden
    [B T U1, J] and glog_c [B T U1, V] (the logits, g_pre and g_W)."""
    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.bfloat16)
    pre, glog, w = mk(B * T * U1, J), mk(B * T * U1, V), mk(V, J)
    ms = device_ms(lambda: (pre @ w.t(), glog @ w, glog.t() @ pre), calls=5)
    del pre, glog
    torch.cuda.empty_cache()
    return ms


def rnnt_lp_cublas_ms(B: int, T: int, U1: int, J: int, V: int, dev) -> float:
    """A yardstick for B4, not a library call for its function: its logits
    product alone through cuBLAS on a materialised bf16 joint hidden
    [B T U1, J] times W^T [J, V]."""
    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.bfloat16)
    pre, w = mk(B * T * U1, J), mk(V, J)
    ms = device_ms(lambda: pre @ w.t(), calls=5)
    del pre
    torch.cuda.empty_cache()
    return ms


def sdpa_fwd_ms(B: int, T: int, heads: int, d: int, dev, rate: float = 0.0) -> float:
    """A yardstick for B1 (and, with dropout ``rate``, for B2), not the same
    function (no relative positions): the device time of
    ``scaled_dot_product_attention``'s forward at the kernel's shape."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, heads, T, d, generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    return device_ms(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate))


def sdpa_bwd_ms(B: int, T: int, heads: int, d: int, rate: float, dev) -> float:
    """A yardstick for B3, not the same function (no relative positions):
    the device time of ``scaled_dot_product_attention``'s backward with
    dropout at B3's shape, as the device time of forward and backward less
    that of the forward alone."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda: torch.randn(B, heads, T, d, generator=g, device=dev, dtype=torch.bfloat16)
    q, k, v, up = (mk().requires_grad_(i < 3) for i in range(4))
    fwd = lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
    both = lambda: torch.autograd.grad(fwd(), (q, k, v), up)
    return device_ms(both) - device_ms(fwd)


def time_pair(name: str, kernel_fn, plain_fn, kernel: str, plain_calls: int = 10,
              per_call=None, calls: int = 20, samples: int = 20) -> dict:
    """Kernel and plain version at one shape: device time from the profiler
    (``ms``, ``plain_ms``; ``calls`` and ``plain_calls`` calls a trace) and,
    for the log, CUDA-event time of back-to-back calls (``samples`` of 10),
    which also counts the host's launch gaps. ``per_call``: the kernels one
    call launches (see ``device_ms``)."""
    row = dict(ms=device_ms(kernel_fn, calls, kernel=kernel, per_call=per_call),
               plain_ms=device_ms(plain_fn, plain_calls))
    row["ms_events"] = median_ms(kernel_fn, samples=samples)
    log(
        f"{name} flagship: kernel {row['ms']} ms device ({row['ms_events']} ms by events of "
        f"back-to-back calls), plain version {row['plain_ms']} ms device"
    )
    return row


def host_us(fn, calls: int = 200) -> float:
    """Median host wall time (us) of one call of ``fn`` over ``calls``
    calls launched back to back with no synchronisation (after 10 warm-up
    calls): what the call costs the host, not the device."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def merge_host_us(dk, m) -> dict:
    """B8's host time a call at the inputs ``m`` (with ``blank_lp``):
    ``unfused_host_us`` for the blank add and the call on its sum (the beam
    decoder's call before the add was folded in), ``host_us`` for the call
    with ``blank_lp``, where the wrapper ``dk.aes_merge`` takes it."""
    import inspect

    pool, exp, lp = m["pool_scores"], m["blank_scores"], m["blank_lp"]
    rest = (m["pool_hash"], m["exp_hash"], m["pool_ver"], m["pool_slot"], 1)
    out = {"unfused_host_us": host_us(lambda: dk.aes_merge(pool, (exp + lp).contiguous(), *rest))}
    if "blank_lp" in inspect.signature(dk.aes_merge).parameters:
        out["host_us"] = host_us(lambda: dk.aes_merge(pool, exp, *rest, blank_lp=lp))
    return out


def build_kernels() -> str:
    from espresso_tpu_torch.features import fbank_kernels
    from espresso_tpu_torch.ops import (
        attention_kernels, cuda_build, decode_kernels, quantization, rnnt_kernels,
    )

    libs = {
        **attention_kernels.LIBRARIES, **decode_kernels.LIBRARIES, **rnnt_kernels.LIBRARIES,
        **fbank_kernels.LIBRARIES, **quantization.LIBRARIES,
    }
    cuda_build.build_many(libs.items())
    return "\n".join(cuda_build.build_log(n, s) for n, s in libs.items())


# ---------------------------------------------------------------------------
# each kernel against its plain version
# ---------------------------------------------------------------------------


def attn_inputs(B: int, T: int, seed: int, dev):
    """q+u, q+v, k, v, p and ragged key masks: the first utterance full and,
    from B = 3 on, the last with one valid key."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    if B >= 3:
        lens[-1] = 1
    key_valid = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid


def check_attention(dev) -> dict:
    from espresso_tpu_torch.ops.attention_kernels import rel_attention, rel_attention_reference
    from espresso_tpu_torch.ops.train_kernel_checks import bf16_ulp

    scale = (D // H) ** -0.5
    worst, row = 0.0, {}
    for i, (B, T) in enumerate(ATTN_SHAPES):
        args = attn_inputs(B, T, seed=i, dev=dev) + (H, scale)
        out = rel_attention(*args)
        torch.cuda.synchronize()
        ref = rel_attention_reference(*args)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2 * bf16_ulp(ref.float().abs().max().item())
        finite = bool(torch.isfinite(out.float()).all())
        log(f"rel_attention B={B} T'={T}: max_abs_err {err} (bound {tol}, 2 bf16 ulps)")
        if not finite or err > tol:
            raise AssertionError(f"rel_attention disagrees at B={B} T'={T}: {err} > {tol}")
        worst = max(worst, err)
        if (B, T) == ATTN_SHAPES[0]:
            # q_u, q_v, k, v, the output [B, T, D] and p [2T-1, D] in bf16,
            # the key mask; ac, bd and w @ v at 2 B T^2 D operations each
            n_bytes = (5 * B * T * D + (2 * T - 1) * D) * 2 + B * T
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 6 * B * T * T * D, PEAK_BF16)
            row.update(time_pair(
                "rel_attention", lambda: rel_attention(*args),
                lambda: rel_attention_reference(*args), "rel_attention_kernel", per_call=1,
            ))
            # a yardstick of the order of size, not the same function:
            # scaled_dot_product_attention's forward, which has no relative
            # positions
            row["sdpa_fwd_ms"] = sdpa_fwd_ms(B, T, H, D // H, dev)
            log(f"rel_attention flagship: sdpa forward {row['sdpa_fwd_ms']} ms device")
    # the long-row mode
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    for B, T in ATTN_LONG_SHAPES:
        err = tc.check_rel_attention(*tc.long_attention_inputs(B, T, seed=T, dev=dev))
        log(f"rel_attention long rows B={B} T'={T} H=2: max_abs_err {err} (bound 2 bf16 ulps)")
        worst = max(worst, err)
    B, T = ATTN_LONG_TIMED
    args = tc.long_attention_inputs(B, T, seed=1, dev=dev, H=H)
    n_bytes = (5 * B * T * D + (2 * T - 1) * D) * 2 + B * T
    row["long_bound_ms"] = bound(n_bytes, 6 * B * T * T * D, PEAK_BF16)[0]
    long = time_pair("rel_attention long rows", lambda: rel_attention(*args),
                     lambda: rel_attention_reference(*args), "rel_attention_long_kernel",
                     plain_calls=3, per_call=1)
    row["long_ms"], row["long_plain_ms"] = long["ms"], long["plain_ms"]
    log(f"rel_attention long rows B={B} T'={T}: bound {row['long_bound_ms']} ms")
    del args
    # a layer past its relative table: the expanded table through B1, B2, B3
    T, L = CLIPPED_LAYER
    log(f"clipped table layer T'={T} L={L}: {tc.check_clipped_table_layer(dev, T=T, L=L)}")
    row["max_abs_err"] = worst
    return row


def check_decode_kernels(dev) -> dict:
    """Each AES kernel at the flagship shape (B=256, K=10, n=12, J=H=512,
    V=1024, T'=156, 2 expansions) and at edge shapes; times kernel and plain
    version at the flagship shape. Returns one row per kernel."""
    from espresso_tpu_torch.ops import decode_kernels as dk
    from espresso_tpu_torch.ops import kernel_checks as kc

    B, K, J, V, T, n_exp = 256, 10, 512, FLAGSHIP["VOCAB"], 156, 2
    n, BK, L = K + BEAM["expansion_beta"], B * K, 2
    rows = {}

    # fused_joint_topk: the flagship, then the edges: V = 5003, 67 and 1032
    # (ragged last tiles of each CTA's share), BK = 2550 (not a multiple of
    # the 64-row tile), J = 128 and 640, n = 1 and 32, a label bias with and
    # without the eos fold
    errs = [kc.check_joint(kc.joint_inputs(B, K, V, J, J, seed=0, dev=dev), K, n)]
    for Bx, Kx, Vx, Jx, nx, fold, bias in JOINT_EDGES:
        a = kc.joint_inputs(Bx, Kx, Vx, Jx, Jx, seed=Vx + Kx, dev=dev, bias=bias)
        errs.append(kc.check_joint(a, Kx, nx, blank=0, eos=2, fold=fold))
    log(f"fused_joint_topk max_abs_err per shape {errs} (bound {kc.JOINT_TOL})")
    a = kc.joint_inputs(B, K, V, J, J, seed=0, dev=dev)
    n_bytes = (BK * J + BK * J + J * J + J * V) * 2 + (BK + 3 * J + V) * 4 + BK * 4 + BK * n * 8
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 2 * BK * J * (J + V), PEAK_BF16)))
    # every kernel the call launches (one)
    row.update(time_pair(
        "fused_joint_topk", lambda: dk.fused_joint_topk(**a, K=K, n_cand=n),
        lambda: dk.fused_joint_topk_reference(**a, K=K, n_cand=n), "", per_call=1,
    ))
    # a yardstick, not a library call for the function: the call's two
    # products alone through cuBLAS ([BK, H] . [H, J] and [BK, J] . [J, V])
    x1, x2 = a["feat"].contiguous(), a["enc_t"]
    wd, wo = a["w_dec"].contiguous(), a["w_out"].contiguous()
    row["cublas_products_ms"] = device_ms(lambda: (x1 @ wd, x2 @ wo))
    # the wide instance
    for Bx, Kx, Vx, Jx, Hx, nx, fold, bias in JOINT_WIDE:
        a = kc.joint_inputs(Bx, Kx, Vx, Jx, Hx, seed=Vx + Jx + Hx + nx, dev=dev, bias=bias)
        errs.append(kc.check_joint(a, Kx, nx, blank=0, eos=2, fold=fold))
    log(f"fused_joint_topk wide instance max_abs_err per shape {errs[-len(JOINT_WIDE):]}")
    Jw = JOINT_WIDE_TIMED
    a = kc.joint_inputs(B, K, V, Jw, Jw, seed=1, dev=dev)
    n_bytes = (2 * BK * Jw + Jw * Jw + Jw * V) * 2 + (BK + 3 * Jw + V) * 4 + BK * 4 + BK * n * 8
    row["wide_bound_ms"] = bound(n_bytes, 2 * BK * Jw * (Jw + V), PEAK_BF16)[0]
    wide = time_pair(f"fused_joint_topk J=H={Jw}", lambda: dk.fused_joint_topk(**a, K=K, n_cand=n),
                     lambda: dk.fused_joint_topk_reference(**a, K=K, n_cand=n), "", per_call=1)
    row["wide_ms"], row["wide_plain_ms"] = wide["ms"], wide["plain_ms"]
    log(f"fused_joint_topk J=H={Jw}: bound {row['wide_bound_ms']} ms")
    rows["fused_joint_topk"] = dict(row, max_abs_err=max(errs))

    # lstm_step_reorder: the flagship, then BK = 1, 12 and 2550, H = 64 and
    # 1024, L = 1 and 3, every row dead and every row live
    errs = [kc.check_lstm(kc.lstm_inputs(B, K, J, L, seed=1, dev=dev), B, K)]
    for Bx, Kx, Hx, Lx, live in LSTM_EDGES:
        errs.append(kc.check_lstm(
            kc.lstm_inputs(Bx, Kx, Hx, Lx, seed=Bx + Hx, dev=dev, live_frac=live), Bx, Kx))
    log(f"lstm_step_reorder max_abs_err per shape {errs} (bound {kc.LSTM_TOL})")
    s = kc.lstm_inputs(B, K, J, L, seed=1, dev=dev)
    # x, S in and out (bf16), the weights, the bias, src (int64), live
    n_bytes = (BK * J + 2 * BK * 2 * L * J + 2 * L * J * 4 * J) * 2 + L * 4 * J * 4 + BK * 9
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, L * 2 * BK * 2 * J * 4 * J, PEAK_BF16)))
    # every kernel the call launches (one a layer)
    row.update(time_pair(
        "lstm_step_reorder", lambda: dk.lstm_step_reorder(**s, B=B, K=K),
        lambda: dk.lstm_step_reorder_reference(**s, B=B, K=K), "", per_call=L,
    ))
    # the yardstick: a layer's product on pre-gathered rows, [BK, 2H] .
    # [2H, 4H], twice, through cuBLAS
    xa = torch.cat([s["x"], s["S"][s["src"], :J]], 1)
    wa = torch.cat([s["w_ih"][0], s["w_hh"][0]], 0).contiguous()
    row["cublas_products_ms"] = device_ms(lambda: (xa @ wa, xa @ wa))
    # the beam_lm point's LM instance: embed 512 gate-padded to H = 1024,
    # L = 3 (prep_lstm_kernel_inputs), at BK = 2560 and 12, some rows dead;
    # timed at BK = 2560 beside its bound and cuBLAS on its products (a
    # layer's [BK, 2H] . [2H, 4H], L times). The bound counts the LM step,
    # not the padded stack: layer 0's products at width E + H, the others'
    # at 2H, the weights and the embedded tokens at their unpadded sizes;
    # the padded stack's products (layer 0 at 2H, its zero columns
    # multiplied too) are reported beside it as lm_padded_gflop
    E_lm, H_lm, L_lm = LM["embed_dim"], LM["hidden_size"], LM["num_layers"]
    errs += [kc.check_lstm(kc.lstm_lm_inputs(Bx, Kx, E_lm, H_lm, L_lm, seed=Bx + 7, dev=dev), Bx, Kx)
             for Bx, Kx in ((B, K), (1, 12))]
    log(f"lstm_step_reorder LM instance max_abs_err {errs[-2:]} (bound {kc.LSTM_TOL})")
    s = kc.lstm_lm_inputs(B, K, E_lm, H_lm, L_lm, seed=B + 7, dev=dev)
    k_rows = (E_lm + H_lm) + (L_lm - 1) * 2 * H_lm  # the rows of the step's gate kernels
    n_bytes = ((BK * E_lm + 2 * BK * 2 * L_lm * H_lm + k_rows * 4 * H_lm) * 2
               + L_lm * 4 * H_lm * 4 + BK * 9)
    lm_flops = 2 * BK * k_rows * 4 * H_lm
    row["lm_bound_ms"], row["lm_bound_by"] = bound(n_bytes, lm_flops, PEAK_BF16)
    Hp_lm = s["w_ih"].shape[1]
    row["lm_padded_gflop"] = L_lm * 2 * BK * 2 * Hp_lm * 4 * Hp_lm / 1e9
    lm = time_pair(
        "lstm_step_reorder LM instance", lambda: dk.lstm_step_reorder(**s, B=B, K=K),
        lambda: dk.lstm_step_reorder_reference(**s, B=B, K=K), "", per_call=L_lm,
    )
    row["lm_ms"], row["lm_plain_ms"] = lm["ms"], lm["plain_ms"]
    xa = torch.cat([s["x"], s["S"][s["src"], :H_lm]], 1)
    wa = torch.cat([s["w_ih"][0], s["w_hh"][0]], 0).contiguous()
    row["lm_cublas_products_ms"] = device_ms(lambda: [xa @ wa for _ in range(L_lm)])
    log(f"lstm_step_reorder LM instance BK={BK} H={H_lm} L={L_lm}: {row['lm_ms']} ms, bound "
        f"{row['lm_bound_ms']} ms ({row['lm_bound_by']}, {lm_flops / 1e9:.1f} GFLOP the step needs; "
        f"the padded stack's products {row['lm_padded_gflop']:.1f} GFLOP), cuBLAS "
        f"products {row['lm_cublas_products_ms']} ms")
    rows["lstm_step_reorder"] = dict(row, max_abs_err=max(errs))
    # B6 as the beam_lm point calls it: with a label bias, returning the
    # factor (its bytes add the bias read and the factor written)
    a = kc.joint_inputs(B, K, V, J, J, seed=0, dev=dev, bias=True)
    r = rows["fused_joint_topk"]
    n_bytes = ((2 * BK * J + J * J + J * V) * 2 + (BK + 3 * J + V) * 4 + BK * 8 + BK * n * 8
               + BK * V * 4)
    r["lm_bound_ms"] = bound(n_bytes, 2 * BK * J * (J + V), PEAK_BF16)[0]
    lm = time_pair("fused_joint_topk with a label bias", lambda: dk.fused_joint_topk(**a, K=K, n_cand=n),
                   lambda: dk.fused_joint_topk_reference(**a, K=K, n_cand=n), "", per_call=1)
    r["lm_ms"], r["lm_plain_ms"] = lm["ms"], lm["plain_ms"]
    for name in ("fused_joint_topk", "lstm_step_reorder"):
        log(f"{name} flagship: cuBLAS products alone {rows[name]['cublas_products_ms']} ms device")

    # aes_merge: without and with the blank add folded in (the beam
    # decoder's call), at the flagship and at edge shapes
    errs = [kc.check_merge(kc.merge_inputs(Bx, Kx, seed=Kx, dev=dev, blank_lp=fused))
            for Bx, Kx in MERGE_SHAPES for fused in (False, True)]
    log(f"aes_merge max_abs_err per shape {errs} (integer outputs exact; with blank_lp "
        f"bit for bit the call on the pre-added scores)")
    m = kc.merge_inputs(B, K, seed=K, dev=dev, blank_lp=True)
    # seven [B, K] inputs and six outputs of 4 bytes; per column a compare,
    # an exp and an add against each of the 2K columns
    row = dict(zip(("bound_ms", "bound_by"), bound(13 * B * K * 4, 3 * B * (2 * K) ** 2, PEAK_FP32)))
    row.update(time_pair(
        "aes_merge", lambda: dk.aes_merge(**m, round_j=1),
        lambda: dk.aes_merge_reference(**m, round_j=1), "aes_merge_kernel", per_call=1,
    ))
    row.update(merge_host_us(dk, m))
    log(f"aes_merge flagship: wrapper host time {row.get('host_us')} us a call with blank_lp, "
        f"{row['unfused_host_us']} us for the blank add and the call on its sum")
    rows["aes_merge"] = dict(row, max_abs_err=max(errs))

    # aes_backtrace
    for Tx, Bx, Kx, nx in [(T, B, K, n_exp), (1, 1, 1, 1), (37, 3, 4, 1)]:
        kc.check_backtrace(kc.backtrace_inputs(Tx, Bx, Kx, nx, V=V, seed=Tx, dev=dev), nx)
    for Tx, Kx in BACKTRACE_EDGES:
        kc.check_backtrace(
            kc.backtrace_inputs(Tx, 5, Kx, n_exp, V=V, seed=Tx + Kx, dev=dev, edges=True), n_exp)
    log(f"aes_backtrace: outputs exact at every shape ({3 + len(BACKTRACE_EDGES)})")
    b = kc.backtrace_inputs(T, B, K, n_exp, V=V, seed=T, dev=dev)
    R, E = n_exp + 1, n_exp
    # what these inputs need moved, 4 bytes an int: active and order read
    # once, the backpointers of the active frames only (an inactive frame
    # passes every slot through whatever they hold), both outputs written
    # once; the walk does no arithmetic beyond integer compares
    n_active = int(b["active"].sum())
    n_bytes = (T * B + B * K + n_active * (2 * R + 2 * E) * K + 2 * T * E * B * K) * 4
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 0.0, PEAK_FP32)))
    row.update(time_pair(
        "aes_backtrace", lambda: dk.aes_backtrace(**b, n_exp=n_exp),
        lambda: dk.aes_backtrace_reference(**b, n_exp=n_exp), "aes_backtrace_kernel",
        plain_calls=2, per_call=1,
    ))
    rows["aes_backtrace"] = dict(row, max_abs_err=0.0)
    for name, r in rows.items():
        log(f"{name} flagship bound: {r['bound_ms']} ms ({r['bound_by']})")
    return rows


def check_train_kernels(dev) -> dict:
    """The train kernels at the flagship train shapes and at edge shapes;
    times kernel and plain version at the flagship shape. Returns one row
    per kernel."""
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc

    rows = {}
    # rel_attention_train forward and backward, rates 0 and 0.1 on one seed
    # (a hash that differs from the plain version's shows up as O(1) error)
    fwd_err = bwd_err = 0.0
    for B, T in ATTN_TRAIN_SHAPES:
        a = tc.attention_train_inputs(B, T, seed=T, dev=dev)
        for rate in (0.0, 0.1):
            errs = tc.check_attention_train(a, H, rate)
            log(f"rel_attention_train B={B} T'={T} rate {rate}: max_abs_err {errs}")
            fwd_err = max(fwd_err, errs["out"])
            bwd_err = max(bwd_err, *(v for k, v in errs.items() if k != "out"))
    for B, T in ATTN_TRAIN_FWD_EDGES:
        a = tc.attention_train_inputs(B, T, seed=T + 2 * B, dev=dev)
        a["key_valid"][-1] = torch.arange(T, device=dev) < 1
        for rate in (0.0, 0.1):
            err = tc.check_attention_train_fwd(a, H, rate)
            log(f"rel_attention_train_fwd B={B} T'={T} rate {rate}: max_abs_err {err}")
            fwd_err = max(fwd_err, err)
    for B, T in ATTN_TRAIN_LONG_SHAPES:
        a = tc.attention_train_inputs(B, T, seed=T + B, dev=dev)
        if B > 1:
            a["key_valid"][-1] = torch.arange(T, device=dev) < 1
        for rate in (0.0, 0.1):
            errs = tc.check_attention_train(a, H, rate)
            log(f"rel_attention_train long B={B} T'={T} rate {rate}: max_abs_err {errs}")
            fwd_err = max(fwd_err, errs["out"])
            bwd_err = max(bwd_err, *(v for k, v in errs.items() if k != "out"))
    scale, rate = (D // H) ** -0.5, TRAIN["DROPOUT"]
    # the long lengths timed: the forward's long-row mode and the backward
    B, T = ATTN_TRAIN_LONG_TIMED
    a = tc.attention_train_inputs(B, T, seed=3, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"])
    long = {
        "fwd": time_pair(
            "rel_attention_train_fwd long rows",
            lambda: ak.rel_attention_train_fwd(*args, a["seed"], H, scale, rate),
            lambda: ak.rel_attention_train_reference(*args, H, scale, rate, a["seed"]),
            "rel_attention_train_fwd_long_kernel", plain_calls=3, per_call=1),
        "bwd": time_pair(
            "rel_attention_train_bwd long",
            lambda: ak.rel_attention_train_bwd(*args, a["seed"], a["g"], H, scale, rate),
            lambda: ak.rel_attention_train_backward_reference(*args, a["g"], H, scale, rate,
                                                              a["seed"]),
            "rel_attention_train_bwd", plain_calls=2),
    }
    long_bytes = {"fwd": (5 * B * T * D + (2 * T - 1) * D) * 2 + B * T,
                  "bwd": (9 * B * T * D + (2 * T - 1) * D) * 2 + (2 * T - 1) * D * 4 + B * T}
    long_flops = {"fwd": 6 * B * T * T * D, "bwd": 16 * B * T * T * D}
    del a, args
    B, T = ATTN_TRAIN_SHAPES[0]
    a = tc.attention_train_inputs(B, T, seed=T, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"])
    # forward: q_u, q_v, k, v and the output [B, T, D] bf16, p, the mask;
    # ac, bd and w @ v at 2 B T^2 D operations each
    n_bytes = (5 * B * T * D + (2 * T - 1) * D) * 2 + B * T
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 6 * B * T * T * D, PEAK_BF16)))
    row.update(time_pair(
        "rel_attention_train_fwd",
        lambda: ak.rel_attention_train_fwd(*args, a["seed"], H, scale, rate),
        lambda: ak.rel_attention_train_reference(*args, H, scale, rate, a["seed"]),
        "rel_attention_train_fwd_kernel", per_call=1,
    ))
    # a yardstick of the order of size, not the same function:
    # scaled_dot_product_attention's forward with the same dropout rate,
    # which has no relative positions
    row["sdpa_fwd_dropout_ms"] = sdpa_fwd_ms(B, T, H, D // H, dev, rate)
    log(f"rel_attention_train_fwd flagship: sdpa forward with dropout {rate} "
        f"{row['sdpa_fwd_dropout_ms']} ms device")
    rows["rel_attention_train_fwd"] = dict(row, max_abs_err=fwd_err)
    # backward: the five inputs and g read, dq_u, dq_v, dk, dv written (bf16),
    # dp (f32); recomputed ac and bd, then dv, dw, dq_u, dk, dq_v and dp
    n_bytes = (9 * B * T * D + (2 * T - 1) * D) * 2 + (2 * T - 1) * D * 4 + B * T
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 16 * B * T * T * D, PEAK_BF16)))
    row.update(time_pair(
        "rel_attention_train_bwd",
        lambda: ak.rel_attention_train_bwd(*args, a["seed"], a["g"], H, scale, rate),
        lambda: ak.rel_attention_train_backward_reference(*args, a["g"], H, scale, rate, a["seed"]),
        "rel_attention_train_bwd", plain_calls=3,
    ))
    bwd_fn = lambda: ak.rel_attention_train_bwd(*args, a["seed"], a["g"], H, scale, rate)
    # the wrapper's whole device time (its dp fill included) and the split
    # by kernel; a yardstick of the order of size, not the same function:
    # scaled_dot_product_attention's backward, which has no relative positions
    row["ms_all_kernels"] = device_ms(bwd_fn)
    row["sdpa_bwd_ms"] = sdpa_bwd_ms(B, T, H, D // H, rate, dev)
    log(f"rel_attention_train_bwd flagship: every kernel of the call {row['ms_all_kernels']} ms, "
        f"split {device_split(bwd_fn)}; sdpa backward {row['sdpa_bwd_ms']} ms device")
    rows["rel_attention_train_bwd"] = dict(row, max_abs_err=bwd_err)
    for part, name in (("fwd", "rel_attention_train_fwd"), ("bwd", "rel_attention_train_bwd")):
        rows[name].update(
            long_ms=long[part]["ms"], long_plain_ms=long[part]["plain_ms"],
            long_bound_ms=bound(long_bytes[part], long_flops[part], PEAK_BF16)[0])
        log(f"{name} long B={ATTN_TRAIN_LONG_TIMED[0]} T'={ATTN_TRAIN_LONG_TIMED[1]}: "
            f"bound {rows[name]['long_bound_ms']} ms")

    # rnnt_joint_lp and rnnt_joint_bwd
    lp_err = bwd_err = 0.0
    for B, T, U, V, blank in RNNT_SHAPES:
        errs = tc.check_rnnt_joint(tc.rnnt_inputs(B, T, U, 512, V, seed=V + T, dev=dev, blank=blank), blank)
        log(f"rnnt joint kernels B={B} T'={T} U={U} V={V} blank={blank}: max_abs_err {errs}")
        lp_err = max(lp_err, errs["lp_blank"], errs["lp_label"], errs["lse"])
        bwd_err = max(bwd_err, errs["g_enc"], errs["g_dec"], errs["g_W"], errs["g_b"])
    B, T, U, V, blank = RNNT_SHAPES[0]
    r = tc.rnnt_inputs(B, T, U, 512, V, seed=V + T, dev=dev, blank=blank)
    ja = (r["enc_proj"], r["dec_proj"], r["fc_kernel"], r["fc_bias"], r["targets"])
    J, U1 = 512, U + 1
    cells = B * T * U1
    # enc_proj, dec_proj, W (bf16), bias and targets read; three [B, T, U1] f32
    # written; the logits at 2 B T U1 J V operations
    n_bytes = (B * T * J + B * U1 * J + V * J) * 2 + V * 4 + B * U1 * 4 + 3 * cells * 4
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 2 * cells * J * V, PEAK_BF16)))
    row.update(time_pair(
        "rnnt_joint_lp", lambda: rk.rnnt_joint_lp(*ja, blank),
        lambda: rk.rnnt_joint_lp_reference(*ja, blank), "rnnt_joint_lp_kernel", plain_calls=2,
    ))
    # a yardstick: the logits product alone through cuBLAS
    row["cublas_products_ms"] = rnnt_lp_cublas_ms(B, T, U1, J, V, dev)
    log(f"rnnt_joint_lp flagship: cuBLAS logits product alone {row['cublas_products_ms']} ms device")
    rows["rnnt_joint_lp"] = dict(row, max_abs_err=lp_err)
    lpb, lpl, lse = rk.rnnt_joint_lp_reference(*ja, blank)
    ob, ol = tc.occupancy_grads(r, lpb, lpl)
    # the inputs above, lse, ob and ol read; g_enc, g_dec, g_W, g_b (f32)
    # written; three products of the logits' size (logits, g_W, g_pre)
    n_bytes = ((B * T * J + B * U1 * J + V * J) * 2 + V * 4 + B * U1 * 4 + 3 * cells * 4
               + (B * T * J + B * U1 * J + J * V + V) * 4)
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 3 * 2 * cells * J * V, PEAK_BF16)))
    row.update(time_pair(
        "rnnt_joint_bwd", lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, blank),
        lambda: rk.rnnt_joint_bwd_reference(*ja, lse, ob, ol, blank), "rnnt_joint_bwd",
        plain_calls=2,
    ))
    bwd_fn = lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, blank)
    # the wrapper's whole device time (its zero fills included) and the
    # split by kernel; a yardstick: the three products alone through cuBLAS
    row["ms_all_kernels"] = device_ms(bwd_fn)
    row["cublas_products_ms"] = rnnt_bwd_cublas_ms(B, T, U1, J, V, dev)
    log(f"rnnt_joint_bwd flagship: every kernel of the call {row['ms_all_kernels']} ms, "
        f"split {device_split(bwd_fn)}; cuBLAS products alone {row['cublas_products_ms']} ms device")
    rows["rnnt_joint_bwd"] = dict(row, max_abs_err=bwd_err)
    for name, r in rows.items():
        log(f"{name} flagship bound: {r['bound_ms']} ms ({r['bound_by']})")
    return rows


def samples_for(frame_lengths: np.ndarray, seed: int) -> np.ndarray:
    """Sample counts that give these frame counts: (L - 1) * shift + window
    plus up to shift - 1 samples that make no further frame."""
    extra = np.random.default_rng(seed).integers(0, SHIFT, size=len(frame_lengths))
    return ((frame_lengths - 1) * SHIFT + WINDOW + extra).astype(np.int32)


def serving_num_samples() -> np.ndarray:
    """The serving batch's frame counts (flagship_lengths) in samples,
    within S = (T - 1) * shift + window."""
    T = FLAGSHIP["T_FRAMES"]
    lengths = flagship_lengths(np.random.default_rng(0))
    return np.minimum(samples_for(lengths, seed=1), (T - 1) * SHIFT + WINDOW)


def windowed_frames(waveforms: torch.Tensor, num_samples: torch.Tensor) -> torch.Tensor:
    """The valid frames of a waveform batch as the fbank kernel's FFT takes
    them: DC removed, pre-emphasised, windowed, zero-padded to 512 ([frames,
    512] f32)."""
    from espresso_tpu_torch.features import fbank_kernels as fk

    x = waveforms.unfold(1, WINDOW, SHIFT)  # [B, T, W]
    lengths = fk.fbank_lengths(num_samples, WINDOW, SHIFT, x.shape[1])
    x = x[torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]]
    x = x - x.mean(1, keepdim=True)
    y = x - fk.PREEMPHASIS * torch.cat([x[:, :1], x[:, :-1]], 1)
    y = y * torch.from_numpy(fk.povey_window(WINDOW)).to(x.device)
    return torch.nn.functional.pad(y, (0, fk.FFT_SIZE - WINDOW)).contiguous()


def rate_waveforms(num_samples, S: int, sample_rate: float, seed: int, dev) -> dict:
    """``front_kernel_checks.waveform_inputs``' signal drawn on the card (a
    serving batch at 96 kHz is 154 M samples): int16-scale noise plus two
    tones an utterance below Nyquist, zero past each count."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(num_samples)
    t = torch.arange(S, device=dev, dtype=torch.float64) / sample_rate
    f = 100 + torch.rand(B, 2, 1, device=dev, generator=g, dtype=torch.float64) * (sample_rate / 2 - 200)
    wav = torch.randn(B, S, device=dev, generator=g, dtype=torch.float64) * 2000.0
    wav += 8000 * torch.sin(2 * math.pi * f[:, 0] * t) + 3000 * torch.sin(2 * math.pi * f[:, 1] * t)
    ns = torch.tensor(num_samples, dtype=torch.int32, device=dev)
    wav = torch.where(torch.arange(S, device=dev)[None, :] < ns[:, None], wav, 0.0)
    return {"waveforms": wav.float(), "num_samples": ns}


def check_front_kernels(dev) -> dict:
    """B10 (fbank) at the serving batch and at edge shapes, by the goldens'
    rule; B11 (int8_matmul) at the flagship FFN shapes and a ragged one, bit
    for bit. Times kernel and plain version at the serving batch and the
    first FFN shape. Returns one row per kernel."""
    from espresso_tpu_torch.features import fbank_kernels as fk
    from espresso_tpu_torch.ops import front_kernel_checks as fc
    from espresso_tpu_torch.ops import quantization as qz

    rows = {}
    S = (FLAGSHIP["T_FRAMES"] - 1) * SHIFT + WINDOW
    ns = serving_num_samples()
    a = fc.waveform_inputs(ns.tolist(), S, seed=0, dev=dev)
    errs = [fc.check_fbank(a)]
    for nums, S_edge in FBANK_EDGES:
        errs.append(fc.check_fbank(fc.waveform_inputs(nums, S_edge, seed=S_edge, dev=dev)))
    errs.append(fc.check_fbank(fc.waveform_inputs([16161, 401], 16161, seed=40, dev=dev),
                               num_mel_bins=40))
    log(f"fbank errors per shape {errs} (bounds: log {fc.FBANK_LOG_TOL} on bins within 70 dB of "
        f"the frame's peak, linear {fc.FBANK_LIN_TOL} of the frame's peak energy)")
    B, T, M = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"], FLAGSHIP["FEAT"]
    valid = int(np.minimum(1 + (ns - WINDOW) // SHIFT, T).sum())
    # the operations the function needs for the frames the lengths make
    # valid, counted as an FFT computes it: a 512-point real FFT (2.5 N
    # log2 N), |X|^2 over its 257 bins, a multiply-add for each non-zero
    # weight of the mel table, ~5 operations a window sample (mean, DC,
    # pre-emphasis, window) and a log a mel bin; the waveforms read and the
    # frames and lengths written once
    nfft = 512
    mel_nnz = int(np.count_nonzero(fk._dft_mel_matrices(WINDOW, nfft, M, 16000.0)[2]))
    fft_flops = valid * (2.5 * nfft * math.log2(nfft) + 3 * (nfft // 2 + 1) + 2 * mel_nnz
                         + 5 * WINDOW + M)
    n_bytes = B * S * 4 + B * 4 + B * T * M * 4 + B * 4
    row = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, fft_flops, PEAK_FP32)))
    row.update(time_pair(
        "fbank", lambda: fk.fbank_fused(a["waveforms"], a["num_samples"]),
        lambda: fk.fbank_plain(a["waveforms"], a["num_samples"]), "fbank_kernel", per_call=1,
    ))
    # a yardstick, not a library call for the function: cuFFT's real FFT
    # (torch.fft.rfft) of the valid frames alone, windowed and zero-padded
    # to 512 as the kernel's FFT takes them
    frames = windowed_frames(a["waveforms"], a["num_samples"])
    row["cufft_ms"] = device_ms(lambda: torch.fft.rfft(frames, dim=1))
    del frames
    # the PCM-fed train point: B=16 utterances of S=164,080 samples, every
    # frame valid
    St, Bt, Tt = (TRAIN["T_FRAMES"] - 1) * SHIFT + WINDOW, TRAIN["B"], TRAIN["T_FRAMES"]
    at = fc.waveform_inputs([St] * Bt, St, seed=2, dev=dev)
    row["train_ms"] = device_ms(lambda: fk.fbank_fused(at["waveforms"], at["num_samples"]),
                                kernel="fbank_kernel", per_call=1)
    row["train_bound_ms"] = bound(Bt * St * 4 + Bt * Tt * M * 4 + 8 * Bt,
                                  fft_flops / valid * Bt * Tt, PEAK_FP32)[0]
    # 8 kHz: edge counts, then the serving batch's frame counts at 8 kHz
    # (S = (T - 1) 80 + 200), timed, its bound from the 256-point function
    for nums, S_edge in FBANK_8K:
        for bins in (M, 40):
            errs.append(fc.check_fbank(
                fc.waveform_inputs(nums, S_edge, seed=S_edge + 8, dev=dev, sample_rate=8000.0),
                num_mel_bins=bins, sample_rate=8000.0))
    lengths = flagship_lengths(np.random.default_rng(0))
    ns8 = ((lengths - 1) * SHIFT_8K + WINDOW_8K).tolist()
    S8 = (T - 1) * SHIFT_8K + WINDOW_8K
    a8 = fc.waveform_inputs(ns8, S8, seed=8, dev=dev, sample_rate=8000.0)
    errs.append(fc.check_fbank(a8, sample_rate=8000.0))
    log(f"fbank 8 kHz errors per shape {errs[-2 * len(FBANK_8K) - 1:]}")
    nnz8 = int(np.count_nonzero(fk._dft_mel_matrices(WINDOW_8K, 256, M, 8000.0)[2]))
    valid8 = int(lengths.sum())
    flops8 = valid8 * (2.5 * 256 * 8 + 3 * 129 + 2 * nnz8 + 5 * WINDOW_8K + M)
    row["khz8_bound_ms"] = bound(B * S8 * 4 + B * T * M * 4 + 8 * B, flops8, PEAK_FP32)[0]
    khz8 = time_pair("fbank 8 kHz", lambda: fk.fbank_fused(a8["waveforms"], a8["num_samples"], 8000.0),
                     lambda: fk.fbank_plain(a8["waveforms"], a8["num_samples"], 8000.0),
                     "fbank_kernel", per_call=1)
    row["khz8_ms"], row["khz8_plain_ms"] = khz8["ms"], khz8["plain_ms"]
    log(f"fbank 8 kHz serving batch B={B} S={S8}: bound {row['khz8_bound_ms']} ms")
    # 22.05 to 96 kHz: edge counts, then the serving batch's frame counts
    # at each rate (the same audio seconds), timed, each bound from its
    # own FFT size
    for sr, edges in FBANK_RATES:
        tag = f"khz{int(sr // 1000)}"
        window, shift = round(sr * 0.025), round(sr * 0.01)
        nfft = fk.kernel_fft_size(fk._next_power_of_two(window))
        for nums, S_edge in edges:
            ae = fc.waveform_inputs(nums, S_edge, seed=S_edge, dev=dev, sample_rate=sr)
            errs += [fc.check_fbank(ae, num_mel_bins=bins, sample_rate=sr) for bins in (M, 40)]
        Sr = (T - 1) * shift + window
        ar = rate_waveforms(((lengths - 1) * shift + window).tolist(), Sr, sr, seed=int(sr), dev=dev)
        errs.append(fc.check_fbank(ar, sample_rate=sr))
        nnz = int(np.count_nonzero(fk._mel_matrix(nfft, M, sr)))
        flops = valid8 * (2.5 * nfft * math.log2(nfft) + 3 * (nfft // 2 + 1) + 2 * nnz + 5 * window + M)
        row[f"{tag}_bound_ms"] = bound(B * Sr * 4 + B * T * M * 4 + 8 * B, flops, PEAK_FP32)[0]
        calls, samples, plain_calls = FBANK_LARGE_TIMING.get(sr, (20, 20, 10))
        r = time_pair(f"fbank {sr / 1000} kHz", lambda: fk.fbank_fused(ar["waveforms"], ar["num_samples"], sr),
                      lambda: fk.fbank_plain(ar["waveforms"], ar["num_samples"], sr), "fbank_kernel",
                      plain_calls=plain_calls, per_call=1, calls=calls, samples=samples)
        row[f"{tag}_ms"], row[f"{tag}_plain_ms"] = r["ms"], r["plain_ms"]
        log(f"fbank {sr / 1000} kHz ({nfft} points, shift {shift}) serving seconds B={B} S={Sr}: "
            f"{r['ms']} ms, bound {row[f'{tag}_bound_ms']} ms; errors {errs[-2 * len(edges) - 1:]}")
        del ar
        torch.cuda.empty_cache()
    rows["fbank"] = dict(row, max_abs_err=max(e["log"] for e in errs), valid_frames=valid,
                         linear_err=max(e["linear"] for e in errs))
    log(f"fbank serving-batch bound: {row['bound_ms']} ms ({row['bound_by']}, {valid} valid "
        f"frames of {B * T}, {fft_flops / 1e9:.3f} GFLOP at FFT level, {n_bytes / 1e6:.1f} MB, "
        f"mel table {mel_nnz} non-zeros); cuFFT's rfft of the valid frames alone "
        f"{row['cufft_ms']} ms; at the train point B={Bt} S={St}: {row['train_ms']} ms "
        f"(bound {row['train_bound_ms']} ms)")

    errs = []
    for M_, K_, N_ in INT8_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            errs.append(fc.check_int8_matmul(fc.int8_inputs(M_, K_, N_, seed=K_, dev=dev, dtype=dtype)))
    log(f"int8_matmul at {INT8_SHAPES} in f32 and bf16: bit-exact (max_abs_err {max(errs)})")
    for i, (M_, K_, N_) in enumerate(INT8_SHAPES[:2]):
        q = fc.int8_inputs(M_, K_, N_, seed=K_, dev=dev)
        # x f32, w_q int8 and its scales read; out f32 written; M K N
        # multiply-adds at the int8 rate
        n_bytes = M_ * K_ * 4 + K_ * N_ + N_ * 4 + M_ * N_ * 4
        r = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 2 * M_ * K_ * N_, PEAK_INT8)))
        r.update(time_pair(
            f"int8_matmul {M_}x{K_}x{N_}", lambda: qz.int8_matmul(q["x"], q["w_q"], q["w_scale"]),
            lambda: qz.int8_matmul_plain(q["x"], q["w_q"], q["w_scale"]), "", plain_calls=3,
        ))
        # the row pass and the product apart (mean of one launch), and a
        # yardstick, not the same function (no quantization, no scales): the
        # int8 product alone through torch._int_mm
        xq = torch.randint(-127, 128, (M_, K_), dtype=torch.int8, device=dev)
        split = device_split(lambda: qz.int8_matmul(q["x"], q["w_q"], q["w_scale"]),
                             per_launch=True)
        r["row_pass_ms"] = sum(v for k, v in split.items() if "quantize_rows" in k)
        r["product_ms"] = sum(v for k, v in split.items() if "int8_gemm" in k)
        try:
            r["int_mm_ms"] = device_ms(lambda: torch._int_mm(xq, q["w_q"]))
        except RuntimeError as e:  # the yardstick only: the kernel was held above
            r["int_mm_ms"] = None
            log(f"torch._int_mm at {M_}x{K_}x{N_} did not run: {e}")
        log(f"int8_matmul {M_}x{K_}x{N_} bound: {r['bound_ms']} ms ({r['bound_by']}); row pass "
            f"{r['row_pass_ms']} ms, product {r['product_ms']} ms a launch; torch._int_mm "
            f"{r['int_mm_ms']} ms")
        del xq
        if i == 0:
            rows["int8_matmul"] = dict(r, max_abs_err=max(errs))
        else:
            rows["int8_matmul"]["second_shape"] = r
    return rows


# ---------------------------------------------------------------------------
# the serving paths
# ---------------------------------------------------------------------------


def flagship_model(dev, layers: int = 16):
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
    from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel

    cfg = TransducerConfig(
        feat_dim=FLAGSHIP["FEAT"],
        vocab_size=FLAGSHIP["VOCAB"],
        encoder=SpeechTransformerConfig(
            encoder_embed_dim=512, encoder_ffn_dim=2048, encoder_layers=layers,
            encoder_heads=8, depthwise_conv_kernel_size=31,
        ),
        pred_embed_dim=512, pred_hidden_size=512, pred_layers=2, joint_dim=512,
    )
    torch.manual_seed(0)
    # bf16 inference: every float parameter and batch-norm statistic
    return TransducerModel(cfg).to(dev, torch.bfloat16).eval()


def flagship_lengths(rng) -> np.ndarray:
    """The serving batch's frame counts: uniform in [T/2, T], the first T."""
    T = FLAGSHIP["T_FRAMES"]
    lengths = rng.integers(T // 2, T + 1, size=FLAGSHIP["B"]).astype(np.int32)
    lengths[0] = T
    return lengths


def flagship_batch(dev) -> dict:
    B, T = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"]
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((B, T, FLAGSHIP["FEAT"]), np.float32))
    lengths = flagship_lengths(rng)
    return {
        "src_frames": frames.to(dev, torch.bfloat16),
        "src_lengths": torch.from_numpy(lengths).to(dev),
    }


def all_kernels():
    from espresso_tpu_torch.ops import decode_kernels
    from espresso_tpu_torch.ops.attention_kernels import rel_attention

    return {"rel_attention": rel_attention, **{f.__name__: f for f in decode_kernels.KERNELS}}


@contextlib.contextmanager
def swapped(swaps):
    """Set module attributes for the duration (comparison and profiling)."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    try:
        for obj, name, fn in swaps:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def plain_versions():
    """Route the attention module and the beam decoder to the plain versions
    (comparison only)."""
    from espresso_tpu_torch.decode import transducer_beam
    from espresso_tpu_torch.modules import attention
    from espresso_tpu_torch.ops import attention_kernels, decode_kernels

    swaps = [(attention, "rel_attention", attention_kernels.rel_attention_reference)]
    for f in decode_kernels.KERNELS:
        swaps.append((transducer_beam, f.__name__, getattr(decode_kernels, f.__name__ + "_reference")))
    return swapped(swaps)


def check_hypotheses(hyps, L_max: int, vocab: int, blank: int, n_best: int):
    """Every n-best list is non-empty, at most ``n_best`` long, sorted by
    score, with finite live scores and tokens in the vocab (never blank)
    within the length cap; returns the tokens of the best hypotheses and of
    all hypotheses."""
    emitted = emitted_all = 0
    for nbest in hyps:
        scores = [h["score"] for h in nbest]
        if not (1 <= len(nbest) <= n_best) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"bad n-best list {scores}")
        for h in nbest:
            toks = h["tokens"]
            if not (math.isfinite(h["score"]) and h["score"] > -1e8 and len(toks) <= L_max):
                raise AssertionError(f"bad hypothesis {h}")
            if len(toks) and (toks.min() < 0 or toks.max() >= vocab or (toks == blank).any()):
                raise AssertionError(f"token out of range {toks}")
            emitted_all += len(toks)
        emitted += len(nbest[0]["tokens"])
    return emitted, emitted_all


def timed_batches(decoder, batch, dev, iters: int = 3):
    """One warm-up batch, then ``iters`` launched back to back, with no host
    synchronisation, and every kernel count set to 0 just before; returns
    (hyps, wall s, counts, peak GB)."""
    t0 = time.perf_counter()
    decoder.decode(batch)
    torch.cuda.synchronize()
    log(f"warm-up batch {time.perf_counter() - t0:.3f} s")
    kernels = all_kernels()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    # launching a batch must not wait for the card: any synchronising call
    # (a device-to-host copy, .item(), nonzero) raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [decoder.decode_async(batch) for _ in range(iters)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hyps = [decoder.collect(h) for h in handles]
    wall = time.perf_counter() - t0
    counts = {name: f.launches for name, f in kernels.items()}
    return hyps, wall, counts, torch.cuda.max_memory_allocated(dev) / 1e9


def profile_batch(decoder, batch) -> dict:
    """One batch under ``torch.profiler``: wall (slowed by the profiler),
    device busy time (the sum of kernel times), busy share, the number of
    device kernels the batch ran (copies and fills not counted), and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decoder.decode(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    n_kernels = sum(e.count for e in avgs if e.device_type == DeviceType.CUDA
                    and not e.key.startswith(("Memcpy", "Memset")))
    top = [(e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count) for e in avgs[:12]]
    # the decode kernels' and B1's device time in the batch (ms, launches)
    decode = {
        name: [sum(e.self_device_time_total for e in avgs if name in e.key) / 1e3,
               sum(e.count for e in avgs if name in e.key)]
        for name in ("fused_joint_topk_kernel", "lstm_layer_kernel", "aes_merge_kernel",
                     "rel_attention_kernel")
    }
    log(
        f"profiled batch: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), {n_kernels} device kernels; B6, B7, B8 and B1 (ms, "
        f"launches): {decode}; "
        f"top kernels (name, ms, count): {top}"
    )
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms, device_kernels=n_kernels,
                decode_kernels=decode)


def run_greedy(model, batch, dev, enc_ms: float) -> dict:
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_greedy import TransducerGreedyDecoder

    B, T = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"]
    iters, n_layers = 3, len(model.encoder.layers)
    decoder = TransducerGreedyDecoder(model, AsrDictionary(enable_bos=True), max_out_factor=0.35)
    hyps, wall, counts, peak_gb = timed_batches(decoder, batch, dev, iters)
    want = {"rel_attention": n_layers * iters}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"greedy launches {counts}, want {want}")
    batch_ms = wall / iters * 1e3
    rtfx = iters * B * T * FRAME_SHIFT_S / wall
    emitted, _ = check_hypotheses([h for b in hyps for h in b], max(int(T * 0.35), 8), FLAGSHIP["VOCAB"], 0, 1)
    log(
        f"greedy decode B={B} T={T}: {wall:.4f} s for {iters} batches, RTFx {rtfx:.1f}; "
        f"encoder {enc_ms:.2f} ms/batch, frame loop {batch_ms - enc_ms:.2f} ms/batch; "
        f"peak memory {peak_gb:.2f} GB; launches {counts}; tokens {emitted / iters:.0f} per batch"
    )
    return dict(
        rtfx=rtfx, wall_s=wall, encoder_ms=enc_ms, frame_loop_ms=batch_ms - enc_ms,
        peak_gb=peak_gb, launches=counts, tokens_per_batch=emitted / iters,
    )


def run_beam(model, batch, dev, enc_ms: float, T_enc: int) -> dict:
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder

    B, T = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"]
    iters, n_layers = 3, len(model.encoder.layers)
    R = BEAM["max_num_expansions_per_step"] + 1
    decoder = TransducerBeamSearchDecoder(model, AsrDictionary(enable_bos=True), **BEAM)
    hyps, wall, counts, peak_gb = timed_batches(decoder, batch, dev, iters)
    want = {
        "rel_attention": n_layers * iters,
        "fused_joint_topk": R * T_enc * iters,
        "lstm_step_reorder": (R - 1) * T_enc * iters,
        "aes_merge": R * T_enc * iters,
        "aes_backtrace": iters,
    }
    if counts != want:
        raise AssertionError(f"beam launches {counts}, want {want}")
    L_max = max(int(T * BEAM["max_out_factor"]), 8)
    emitted, emitted_all = check_hypotheses(
        [h for b in hyps for h in b], L_max, FLAGSHIP["VOCAB"], 0, BEAM["beam_size"]
    )
    batch_ms = wall / iters * 1e3
    rtfx = iters * B * T * FRAME_SHIFT_S / wall
    log(
        f"beam decode B={B} T={T} (T'={T_enc}): {wall:.4f} s for {iters} batches, RTFx {rtfx:.1f}; "
        f"encoder {enc_ms:.2f} ms/batch, frame loop {batch_ms - enc_ms:.2f} ms/batch; "
        f"peak memory {peak_gb:.2f} GB; launches per batch "
        f"{ {k: v / iters for k, v in counts.items()} }; "
        f"tokens per batch {emitted / iters:.0f} in the best hypotheses, "
        f"{emitted_all / iters:.0f} in all n-best hypotheses (L_max {L_max})"
    )
    return dict(
        rtfx=rtfx, wall_s=wall, encoder_ms=enc_ms, frame_loop_ms=batch_ms - enc_ms,
        peak_gb=peak_gb, launches=counts, tokens_per_batch=emitted / iters,
        nbest_tokens_per_batch=emitted_all / iters, profile=profile_batch(decoder, batch),
    )


def lm_model(dev):
    """The beam_lm point's LSTM LM from a seeded init, bf16."""
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig

    torch.manual_seed(1)
    return LSTMLanguageModel(LSTMLMConfig(**LM)).to(dev, torch.bfloat16).eval()


def run_beam_lm(model, lm, batch, dev, enc_ms: float, T_enc: int) -> dict:
    """The serving batch at bench_decode.py's beam_lm point: BEAM fused with
    the LSTM LM at LM_WEIGHT. Every frame B6 and B8 three times, B7 twice for
    the prediction net and twice for the LM; B9 once a batch."""
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder

    B, T = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"]
    iters, n_layers = 3, len(model.encoder.layers)
    R = BEAM["max_num_expansions_per_step"] + 1
    decoder = TransducerBeamSearchDecoder(
        model, AsrDictionary(enable_bos=True), **BEAM, lm=lm, lm_weight=LM_WEIGHT
    )
    hyps, wall, counts, peak_gb = timed_batches(decoder, batch, dev, iters)
    want = {
        "rel_attention": n_layers * iters,
        "fused_joint_topk": R * T_enc * iters,
        "lstm_step_reorder": 2 * (R - 1) * T_enc * iters,
        "aes_merge": R * T_enc * iters,
        "aes_backtrace": iters,
    }
    if counts != want:
        raise AssertionError(f"beam_lm launches {counts}, want {want}")
    L_max = max(int(T * BEAM["max_out_factor"]), 8)
    emitted, emitted_all = check_hypotheses(
        [h for b in hyps for h in b], L_max, FLAGSHIP["VOCAB"], 0, BEAM["beam_size"]
    )
    batch_ms = wall / iters * 1e3
    rtfx = iters * B * T * FRAME_SHIFT_S / wall
    log(
        f"beam_lm decode B={B} T={T} (T'={T_enc}), LM {LM} at {LM_WEIGHT}: {wall:.4f} s for {iters} "
        f"batches, RTFx {rtfx:.1f}; encoder {enc_ms:.2f} ms/batch, frame loop "
        f"{batch_ms - enc_ms:.2f} ms/batch; peak memory {peak_gb:.2f} GB; launches per batch "
        f"{ {k: v / iters for k, v in counts.items()} }; tokens per batch {emitted / iters:.0f} in "
        f"the best hypotheses, {emitted_all / iters:.0f} in all n-best hypotheses"
    )
    return dict(
        rtfx=rtfx, wall_s=wall, encoder_ms=enc_ms, frame_loop_ms=batch_ms - enc_ms,
        peak_gb=peak_gb, launches=counts, tokens_per_batch=emitted / iters,
        nbest_tokens_per_batch=emitted_all / iters, profile=profile_batch(decoder, batch),
    )


def compare_encoder(model, batch, sub=slice(0, 8)) -> float:
    """The encoder output on a sub-batch: kernel vs plain attention."""
    frames, lengths = batch["src_frames"][sub], batch["src_lengths"][sub]
    with torch.no_grad():
        out = model.encode(frames, lengths).encoder_out.float()
        with plain_versions():
            ref = model.encode(frames, lengths).encoder_out.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("encoder output not finite")
    err = (out - ref).abs().max().item()
    log(f"encoder sub-batch kernel vs plain: max_abs_err {err} (bound {ENCODER_ATOL})")
    if err > ENCODER_ATOL:
        raise AssertionError(f"encoder output disagrees: {err} > {ENCODER_ATOL}")
    return err


def _agreement(got, want) -> dict:
    """The largest relative difference of the top-1 scores of two decodes and
    the utterances whose top-1 tokens agree."""
    rel = [abs(g[0]["score"] - w[0]["score"]) / abs(w[0]["score"]) for g, w in zip(got, want)]
    same = sum(np.array_equal(g[0]["tokens"], w[0]["tokens"]) for g, w in zip(got, want))
    return dict(top1_score_max_rel_diff=max(rel), top1_tokens_equal=int(same), utterances=len(got))


def in_situ(decoder, stats: dict):
    """Swaps for the beam decoder's B6 and B7 wrappers: each call launches the
    kernel and holds its outputs against the plain version's on the same
    inputs, by ``check_joint``'s and ``check_lstm``'s rules (an
    ``AssertionError`` beyond JOINT_TOL or LSTM_TOL); the decode goes on
    with the kernel's outputs. Appends each call's max error to ``stats``
    under fused_joint_topk, lstm_lm (the LM's cell stack) or lstm_pred, and
    for B7 the share of the live rows' state values that differ from the
    plain version's under lstm_lm_share or lstm_pred_share."""
    import inspect

    from espresso_tpu_torch.decode import transducer_beam
    from espresso_tpu_torch.ops import decode_kernels as dk
    from espresso_tpu_torch.ops import kernel_checks as kc

    joint_sig, lstm_sig = inspect.signature(dk.fused_joint_topk), inspect.signature(dk.lstm_step_reorder)

    def joint(*args, **kw):
        b = joint_sig.bind(*args, **kw)
        b.apply_defaults()
        o = b.arguments
        got = dk.fused_joint_topk(*args, **kw)
        want = dk.fused_joint_topk_reference(*args, **kw)
        a = {k: v for k, v in o.items() if isinstance(v, torch.Tensor)}
        stats["fused_joint_topk"].append(kc.compare_joint(
            a, o["K"], o["n_cand"], got, want, o["blank"], o["eos"], o["fold_eos_into_blank"]))
        return got

    def lstm(*args, **kw):
        a = {k: v for k, v in lstm_sig.bind(*args, **kw).arguments.items() if k not in ("B", "K")}
        got = dk.lstm_step_reorder(*args, **kw)
        want = dk.lstm_step_reorder_reference(*args, **kw)
        err = kc.compare_lstm(a, got, want)
        key = "lstm_pred" if a["w_ih"] is decoder.pred_w["w_ih"] else "lstm_lm"
        stats[key].append(err)
        # the share of the live rows' state values that differ
        stats[key + "_share"].append((got != want)[a["live"]].float().mean().item())
        return got

    return swapped([(transducer_beam, "fused_joint_topk", joint),
                    (transducer_beam, "lstm_step_reorder", lstm)])


def one_ulp_noise(decoder, stack: str, seed: int):
    """A swap for the beam decoder's B7 wrapper, for a decode through the
    plain versions: after each step of one cell stack (``stack`` "lm" or
    "pred", the prediction net's), half the live rows' nonzero state values
    (drawn from ``seed``) move one bf16 step up or down, the size of the
    differences B7 leaves in a state."""
    from espresso_tpu_torch.decode import transducer_beam
    from espresso_tpu_torch.ops import decode_kernels as dk

    g = torch.Generator(device=decoder.pred_w["w_ih"].device).manual_seed(seed)

    def lstm(x, S, src, live, w_ih, b_ih, w_hh, B, K):
        out = dk.lstm_step_reorder_reference(x, S, src, live, w_ih, b_ih, w_hh, B=B, K=K)
        if (w_ih is decoder.pred_w["w_ih"]) != (stack == "pred"):
            return out
        flip = (torch.rand(out.shape, generator=g, device=out.device) < 0.5) & live[:, None] & (out != 0)
        step = torch.randint(0, 2, out.shape, generator=g, device=out.device, dtype=torch.int16) * 2 - 1
        return (out.view(torch.int16) + torch.where(flip, step, 0).to(torch.int16)).view(torch.bfloat16)

    return swapped([(transducer_beam, "lstm_step_reorder", lstm)])


def compare_beam(model, batch, lm=None) -> dict:
    """An 8-utterance beam decode with the joint peaked x6 (hypotheses are
    not empty and near-ties are rare), through the kernels and through the
    plain versions: top-1 scores within BEAM_SCORE_RTOL, token agreement
    reported. With ``lm``, fused with it at LM_WEIGHT, and every B6 and B7
    call of the kernel decode held against its plain version on the same
    inputs (``in_situ``); at the LM as built its log-probs are nearly flat,
    so the decodes' agreement alone could not show a wrong LM term. With
    the LM's output layer peaked x4 as well, the decode through the kernels
    (held in situ too) and, as witnesses of how far one-ulp differences in
    a state move the decode, the plain decode with one-ulp noise in the
    LM's state and in the prediction net's (``one_ulp_noise``), each
    against the plain decode: reported, with no bound."""
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
    from espresso_tpu_torch.ops import kernel_checks as kc

    peaked = copy.deepcopy(model)
    with torch.no_grad():
        peaked.joint.fc_out.weight.mul_(6)
        peaked.joint.fc_out.bias.mul_(6)
    sub = {k: v[:8] for k, v in batch.items()}
    dic = AsrDictionary(enable_bos=True)
    L_max = max(int(FLAGSHIP["T_FRAMES"] * BEAM["max_out_factor"]), 8)
    name = "beam" if lm is None else "beam_lm"

    def decoder(lm_):
        kw = {} if lm_ is None else dict(lm=lm_, lm_weight=LM_WEIGHT)
        return TransducerBeamSearchDecoder(peaked, dic, **BEAM, **kw)

    stats = {k: [] for k in ("fused_joint_topk", "lstm_lm", "lstm_pred", "lstm_lm_share",
                             "lstm_pred_share")}
    dec = decoder(lm)
    with in_situ(dec, stats) if lm is not None else contextlib.nullcontext():
        got = dec.decode(sub)
    with plain_versions():
        want = decoder(lm).decode(sub)
    for hyps in (got, want):
        check_hypotheses(hyps, L_max, FLAGSHIP["VOCAB"], 0, BEAM["beam_size"])
    out = _agreement(got, want)
    rel = out["top1_score_max_rel_diff"]
    log(
        f"{name} sub-batch kernels vs plain: top-1 scores {[round(g[0]['score'], 4) for g in got]} vs "
        f"{[round(w[0]['score'], 4) for w in want]}; lengths {[len(g[0]['tokens']) for g in got]}; "
        f"top-1 tokens equal in {out['top1_tokens_equal']} of {len(got)}; max relative score "
        f"difference {rel} (bound {BEAM_SCORE_RTOL})"
    )
    if rel > BEAM_SCORE_RTOL:
        raise AssertionError(f"beam top-1 scores disagree by {rel} > {BEAM_SCORE_RTOL} relative")
    if lm is None:
        return out

    lm4 = copy.deepcopy(lm)
    with torch.no_grad():
        lm4.decoder.fc_out.weight.mul_(4)
        lm4.decoder.fc_out.bias.mul_(4)
    dec = decoder(lm4)
    with in_situ(dec, stats):
        got4 = dec.decode(sub)
    noisy = {}
    with plain_versions():
        want4 = decoder(lm4).decode(sub)
        for stack in ("lm", "pred"):
            dec = decoder(lm4)
            with one_ulp_noise(dec, stack, seed=5):
                noisy[stack] = dec.decode(sub)
    for hyps in (got4, want4, *noisy.values()):
        check_hypotheses(hyps, L_max, FLAGSHIP["VOCAB"], 0, BEAM["beam_size"])
    out["in_situ"] = {k: dict(calls=len(stats[k]), max_abs_err=max(stats[k]))
                      for k in ("fused_joint_topk", "lstm_lm", "lstm_pred")}
    for k in ("lstm_lm", "lstm_pred"):
        out["in_situ"][k]["mean_share_differing"] = statistics.fmean(stats[k + "_share"])
    out["lm_peaked_x4"] = dict(
        kernels_vs_plain=_agreement(got4, want4),
        **{f"plain_{k}_one_ulp_noise_vs_plain": _agreement(v, want4) for k, v in noisy.items()},
    )
    log(f"beam_lm sub-batch, every B6 and B7 call held against its plain version on its inputs "
        f"(bounds {kc.JOINT_TOL}, {kc.LSTM_TOL}): {out['in_situ']}; LM output layer x4: "
        f"{out['lm_peaked_x4']}")
    return out


# ---------------------------------------------------------------------------
# serving from PCM: the feature front, then the beam decoder
# ---------------------------------------------------------------------------


def feature_config(cmvn_path: str, specaugment=None, quant_noise: float = 0.0):
    """The flagship recipe's data section (conformer_transducer_librispeech
    .yaml:28-35, run.sh:78-82): device fbank, global CMVN, SpecAugment."""
    from espresso_tpu_torch.config import EspressoConfig

    cfg = EspressoConfig()
    cfg.dataset.feature_type = "device_fbank"
    cfg.dataset.global_cmvn_stats_path = cmvn_path
    cfg.dataset.specaugment_config = specaugment
    cfg.optimization.quant_noise_pq = quant_noise
    return cfg


def write_cmvn_stats(pcm: dict, path: str) -> None:
    """Global CMVN stats of the batch's own fbank frames, accumulated on the
    host by the port's compute_global_cmvn_stats, saved to ``path``."""
    from espresso_tpu_torch.features.cmvn import compute_global_cmvn_stats
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused

    frames, lengths = fbank_fused(pcm["src_waveforms"], pcm["num_samples"])
    frames, lengths = frames.cpu(), lengths.cpu().tolist()
    np.savez(path, **compute_global_cmvn_stats(frames[b, :n] for b, n in enumerate(lengths)))


def run_beam_from_pcm(model, dev, tmpdir: str, frame_batch_ms: float, frame_launches: dict) -> dict:
    """The 256-utterance batch as PCM through make_device_feature_fn (B10,
    global CMVN) and the AES beam decoder: one warm-up batch and one timed
    batch; the front's device time by CUDA events and its share of the
    batch; one B10 launch a batch and every other kernel launched as often
    as in a frame-fed batch of the same B, T and lengths
    (``frame_launches``); no host sync in the front or in launching the
    decode."""
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.ops import front_kernel_checks as fc
    from espresso_tpu_torch.train.trainer import make_device_feature_fn

    T = FLAGSHIP["T_FRAMES"]
    S = (T - 1) * SHIFT + WINDOW
    a = fc.waveform_inputs(serving_num_samples().tolist(), S, seed=0, dev=dev)
    pcm = {"src_waveforms": a["waveforms"], "num_samples": a["num_samples"]}
    cmvn = f"{tmpdir}/cmvn.npz"
    write_cmvn_stats(pcm, cmvn)
    prepare = make_device_feature_fn(feature_config(cmvn))
    decoder = TransducerBeamSearchDecoder(model, AsrDictionary(enable_bos=True), **BEAM)
    t0 = time.perf_counter()
    decoder.decode(prepare(pcm))
    torch.cuda.synchronize()
    log(f"PCM beam warm-up batch {time.perf_counter() - t0:.3f} s")
    kernels = {**all_kernels(), "fbank": fbank_fused}
    for f in kernels.values():
        f.launches = 0
    start, mid = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        feats = prepare(pcm)
        mid.record()
        handle = decoder.decode_async(feats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hyps = decoder.collect(handle)
    wall_ms = (time.perf_counter() - t0) * 1e3
    front_ms = start.elapsed_time(mid)
    counts = {name: f.launches for name, f in kernels.items()}
    want = {**frame_launches, "fbank": 1}
    if counts != want:
        raise AssertionError(f"PCM beam batch launches {counts}, want {want}")
    if feats["src_frames"].shape != (FLAGSHIP["B"], T, FLAGSHIP["FEAT"]) or not bool(
            torch.isfinite(feats["src_frames"]).all()):
        raise AssertionError(f"front output {tuple(feats['src_frames'].shape)} not finite or shaped")
    L_max = max(int(T * BEAM["max_out_factor"]), 8)
    emitted, _ = check_hypotheses(hyps, L_max, FLAGSHIP["VOCAB"], 0, BEAM["beam_size"])
    out = dict(batch_ms=wall_ms, front_ms=front_ms, front_share=front_ms / wall_ms,
               frame_fed_batch_ms=frame_batch_ms,
               rtfx=FLAGSHIP["B"] * T * FRAME_SHIFT_S / (wall_ms / 1e3),
               launches=counts, tokens_in_best=emitted)
    log(f"beam from PCM B={FLAGSHIP['B']} S={S}: batch {wall_ms:.1f} ms (frame-fed "
        f"{frame_batch_ms:.1f} ms), front {front_ms:.3f} ms device ({front_ms / wall_ms:.2%} of "
        f"the batch), no host sync in the front; launches {counts}")
    return out


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------


def analytic_flops(B, T, U, feat, d, ffn, layers, heads, J, V, pred_layers):
    """Forward multiply-add FLOPs (x2 per MAC) of the flagship step, times 3
    for forward and backward: the analytic count of bench_train.py:29-56,
    copied (the conv frontend, the conformer layers, the LSTM prediction net,
    the joint projections and the (t, u, V) output product)."""
    T4 = T // 4  # two stride-2 convs
    c = 64
    fe = 2 * (T * feat * c * 9) + 2 * (T // 2 * feat // 2 * c * c * 9)
    ffn_f = 2 * (2 * d * ffn) * 2  # two half-FFNs, each two matmuls
    qkvo = 2 * (4 * d * d)
    scores = 2 * (2 * T4 * d) * 2  # QK^T + AV, x2 for rel-pos term
    convm = 2 * (2 * d * 2 * d) + 2 * (31 * d) + 2 * (d * d)
    enc = layers * (B * T4) * (ffn_f + qkvo + scores + convm)
    lstm = B * (U + 1) * pred_layers * 2 * (4 * (d * d + d * d))
    joint = B * T4 * 2 * d * J + B * (U + 1) * 2 * d * J + B * T4 * (U + 1) * 2 * J * V
    fwd = fe + enc + lstm + joint
    return 3 * fwd


class _Dictionary:
    """The flagship's symbols as the train criterion reads them."""

    def pad(self):
        return 1

    def blank(self):
        return 0


def train_kernels():
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk

    fns = (ak.rel_attention_train_fwd, ak.rel_attention_train_bwd, rk.rnnt_joint_lp, rk.rnnt_joint_bwd)
    return {f.__name__: f for f in fns}


def train_model(dev, dropout: float, layers: int = 16):
    """The flagship with fp32 weights from a seeded init; the train state
    makes the bf16 compute copies."""
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
    from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel

    cfg = TransducerConfig(
        feat_dim=FLAGSHIP["FEAT"],
        vocab_size=FLAGSHIP["VOCAB"],
        encoder=SpeechTransformerConfig(
            encoder_embed_dim=512, encoder_ffn_dim=2048, encoder_layers=layers,
            encoder_heads=8, depthwise_conv_kernel_size=31, dropout=dropout,
        ),
        pred_embed_dim=512, pred_hidden_size=512, pred_layers=2, pred_dropout=dropout,
        joint_dim=512,
    )
    torch.manual_seed(0)
    return TransducerModel(cfg).to(dev)


def train_batch(dev, B: int) -> dict:
    """bench_train.py:110-122's batch with one microbatch: full-length
    utterances, U=100 targets in [4, V)."""
    T, U, V = TRAIN["T_FRAMES"], TRAIN["U"], FLAGSHIP["VOCAB"]
    rng = np.random.default_rng(0)
    batch = {
        "src_frames": rng.standard_normal((1, B, T, FLAGSHIP["FEAT"]), np.float32),
        "src_lengths": np.full((1, B), T, np.int32),
        "prev_output_tokens": rng.integers(4, V, (1, B, U + 1)).astype(np.int32),
        "target": rng.integers(4, V, (1, B, U)).astype(np.int32),
        "tgt_lengths": np.full((1, B), U, np.int32),
        "weight": np.ones((1, B), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def trainer(model, cfg=None):
    """bench_train.py:124-127's config (on ``cfg``'s data section when one
    is given): bf16 compute, adam at the default fixed lr 1e-3, clip 2.0;
    returns (state, train_step)."""
    from espresso_tpu_torch.config import EspressoConfig
    from espresso_tpu_torch.criterions import TransducerCriterion
    from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_train_step

    cfg = cfg or EspressoConfig()
    cfg.common.dtype = "bfloat16"
    cfg.optimization.clip_norm = 2.0
    optimizer, _ = build_optimizer(cfg)
    state = create_train_state(model, optimizer, cfg)
    criterion = TransducerCriterion(cfg.criterion, _Dictionary())
    return state, make_train_step(model, criterion, optimizer, cfg)


def profile_train_step(step, state, batch, gen) -> dict:
    """One step under ``torch.profiler`` with named ranges around the alpha
    and beta DP loops, the teacher-forced LSTM forward and the optimizer:
    wall (slowed by the profiler), device busy time, and device and host
    time by part."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from espresso_tpu_torch.models.transducer import TransducerPredNet
    from espresso_tpu_torch.ops import rnnt_fused
    from espresso_tpu_torch.train.trainer import Adam

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    swaps = [
        (rnnt_fused, "_forward_alpha", ranged("dp_alpha", rnnt_fused._forward_alpha)),
        (rnnt_fused, "_backward_beta", ranged("dp_beta", rnnt_fused._backward_beta)),
        (TransducerPredNet, "sequence", ranged("lstm_sequence_fwd", TransducerPredNet.sequence)),
        (Adam, "step", ranged("optimizer", Adam.step)),
    ]
    torch.cuda.synchronize()
    with swapped(swaps), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # every kernel is listed once, under the host op that launched it; a
    # range's device time is that of the kernels its ops launched (the
    # profiler's spans of the ranges on the device timeline are not used)
    host_ops = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    kernels = [k for e in host_ops for k in e.kernels]
    busy_ms = sum(k.duration for k in kernels) / 1e3
    by_kernel = lambda sub: sum(k.duration for k in kernels if sub in k.name) / 1e3
    parts = {
        "attention_kernels_device_ms": by_kernel("rel_attention_train"),
        "joint_kernels_device_ms": by_kernel("rnnt_joint"),
        "joint_lp_device_ms": by_kernel("rnnt_joint_lp"),
    }
    for name in ("dp_alpha", "dp_beta", "lstm_sequence_fwd", "optimizer"):
        ranges = [e for e in host_ops if e.name == name]
        parts[f"{name}_host_ms"] = sum(e.cpu_time_total for e in ranges) / 1e3
        parts[f"{name}_device_ms"] = sum(e.device_time_total for e in ranges) / 1e3
    per_name = {}
    for k in kernels:
        ms, n = per_name.get(k.name, (0.0, 0))
        per_name[k.name] = (ms + k.duration / 1e3, n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]
    log(
        f"profiled train step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}); parts {parts}; top kernels (name, ms, count): "
        f"{[(name[:70], round(ms, 3), n) for name, (ms, n) in top]}"
    )
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms, **parts)


def run_train(dev) -> dict:
    B, T, U, steps = TRAIN["B"], TRAIN["T_FRAMES"], TRAIN["U"], TRAIN["STEPS"]
    model = train_model(dev, TRAIN["DROPOUT"])
    state, step = trainer(model)
    batch = train_batch(dev, B)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    log(f"train warm-up step {time.perf_counter() - t0:.3f} s, loss {m['loss'].item()}")
    kernels = {**all_kernels(), **train_kernels()}
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        metrics.append(m)
    # the host fetch of the losses ends the clock
    losses = torch.stack([m["loss"] for m in metrics]).tolist()
    wall = time.perf_counter() - t0
    counts = {name: f.launches for name, f in kernels.items()}
    gnorms = torch.stack([m["gnorm"] for m in metrics]).tolist()
    overflow = torch.stack([m["overflow"] for m in metrics]).sum().item()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_layers = len(model.encoder.layers)
    want = {
        "rel_attention_train_fwd": n_layers * steps, "rel_attention_train_bwd": n_layers * steps,
        "rnnt_joint_lp": steps, "rnnt_joint_bwd": steps,
    }
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"train launches {counts}, want {want}")
    if not all(math.isfinite(x) for x in losses + gnorms) or overflow:
        raise AssertionError(f"train losses {losses}, gnorms {gnorms}, overflow {overflow}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    step_s = wall / steps
    flops = analytic_flops(B, T, U, FLAGSHIP["FEAT"], 512, 2048, 16, 8, 512, FLAGSHIP["VOCAB"], 2)
    out = dict(
        ms_per_step=step_s * 1e3,
        audio_s_per_s=B * T * FRAME_SHIFT_S / step_s,
        peak_gb=peak_gb,
        mfu=flops / step_s / PEAK_BF16,
        analytic_gflop_per_step=flops / 1e9,
        losses=losses,
        gnorms=gnorms,
        launches={k: v for k, v in counts.items() if v},
    )
    log(
        f"train B={B} T={T} U={U}: {out['ms_per_step']:.1f} ms/step over {steps} steps, "
        f"{out['audio_s_per_s']:.1f} audio s/s, MFU {out['mfu']:.4f}, peak {peak_gb:.2f} GB; "
        f"losses {losses}; gnorms {gnorms}; launches {out['launches']}"
    )
    out["profile"] = profile_train_step(step, state, batch, gen)
    return out


class NoiseProbe:
    """A criterion that, before it runs, reads the compute copies the step
    has noised: the share of zeroed 8-blocks in the noised leaves (in their
    flax layout), and whether the fp32 masters still equal ``masters``."""

    def __init__(self, criterion, model, state, masters):
        from espresso_tpu_torch.ops.quantization import QuantNoise

        self.criterion, self.state, self.masters = criterion, state, masters
        self.logging_keys = criterion.logging_keys
        self.leaves = QuantNoise(model, QUANT_NOISE_P).leaves
        self.shapes = {n: p.shape for n, p in model.named_parameters()}

    def __call__(self, model, mb):
        from espresso_tpu_torch.bridge import to_flax_layout

        zero = total = 0
        with torch.no_grad():
            for name, off, n, _, leaf, _ in self.leaves:
                w = to_flax_layout(leaf, self.state.compute[off : off + n].view(self.shapes[name]))
                w = torch.nn.functional.pad(w.reshape(-1), (0, -n % 8), value=1.0)
                zero += int((w.view(-1, 8) == 0).all(1).sum())
                total += w.numel() // 8
        self.zero_share = zero / total
        self.masters_untouched = bool(torch.equal(self.state.params, self.masters))
        return self.criterion(model, mb)


def run_train_from_pcm(dev, tmpdir: str, frame_ms: float) -> dict:
    """bench_train.py's point fed PCM (B=16, S=164,080) with the recipe's
    front: device fbank (B10), global CMVN, SpecAugment with time warp. A
    warm-up step and 3 steps: finite losses, no skipped update, one B10
    launch a step; the front and the SpecAugment draws make no host sync.
    Then two steps with quant noise p=0.1: finite losses; in the first, ~p
    of the noised leaves' 8-blocks zeroed and the fp32 masters never
    noised; the second timed."""
    from espresso_tpu_torch.criterions import TransducerCriterion
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.features.specaugment import (
        SpecAugmentConfig, apply_specaugment, draw_specaugment,
    )
    from espresso_tpu_torch.ops import front_kernel_checks as fc
    from espresso_tpu_torch.train.trainer import build_optimizer, make_device_feature_fn, make_train_step

    B, T, steps = TRAIN["B"], TRAIN["T_FRAMES"], 3
    S = (T - 1) * SHIFT + WINDOW
    model = train_model(dev, TRAIN["DROPOUT"])
    a = fc.waveform_inputs([S] * B, S, seed=2, dev=dev)
    frames_batch = train_batch(dev, B)
    batch = {k: v for k, v in frames_batch.items() if not k.startswith("src_")}
    batch["src_waveforms"], batch["num_samples"] = a["waveforms"][None], a["num_samples"][None]
    cmvn = f"{tmpdir}/cmvn_train.npz"
    write_cmvn_stats({k: v[0] for k, v in batch.items()}, cmvn)
    cfg = feature_config(cmvn, SPECAUGMENT)
    state, step = trainer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)

    # the step's front on its own: fbank, CMVN, SpecAugment's draws and
    # masks, warmed up once, then timed by CUDA events and launched with no
    # host sync
    prepare, spec = make_device_feature_fn(cfg), SpecAugmentConfig.from_string(SPECAUGMENT)
    mb = {k: v[0] for k, v in batch.items()}

    def front():
        feats = prepare(mb)
        x = feats["src_frames"]
        draws = draw_specaugment(B, x.shape[-1], spec, gen, dev)
        return feats, apply_specaugment(x, feats["src_lengths"], draws, spec)

    front()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        feats, x = front()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    front_ms = start.elapsed_time(end)
    if not bool(torch.isfinite(x).all()) or bool((x == feats["src_frames"]).all()):
        raise AssertionError("SpecAugment left the frames unchanged or not finite")

    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    log(f"PCM train warm-up step {time.perf_counter() - t0:.3f} s, loss {m['loss'].item()}")
    kernels = {**train_kernels(), "fbank": fbank_fused}
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        metrics.append(m)
    losses = torch.stack([m["loss"] for m in metrics]).tolist()
    wall = time.perf_counter() - t0
    counts = {name: f.launches for name, f in kernels.items()}
    overflow = torch.stack([m["overflow"] for m in metrics]).sum().item()
    n_layers = len(model.encoder.layers)
    want = {"rel_attention_train_fwd": n_layers * steps, "rel_attention_train_bwd": n_layers * steps,
            "rnnt_joint_lp": steps, "rnnt_joint_bwd": steps, "fbank": steps}
    if counts != want:
        raise AssertionError(f"PCM train launches {counts}, want {want}")
    if not all(math.isfinite(x) for x in losses) or overflow:
        raise AssertionError(f"PCM train losses {losses}, overflow {overflow}")
    ms = wall / steps * 1e3
    log(f"train from PCM B={B} S={S}: {ms:.1f} ms/step over {steps} steps (frame-fed "
        f"{frame_ms:.1f} ms/step); the front (fbank, CMVN, SpecAugment) {front_ms:.3f} ms "
        f"({front_ms / ms:.2%} of a step), no host sync in it; losses {losses}; launches {counts}")

    # one step with quant noise, on the same state
    qcfg = feature_config(cmvn, SPECAUGMENT, quant_noise=QUANT_NOISE_P)
    qcfg.common.dtype, qcfg.optimization.clip_norm = "bfloat16", 2.0
    optimizer, _ = build_optimizer(qcfg)
    probe = NoiseProbe(TransducerCriterion(qcfg.criterion, _Dictionary()), model, state,
                       state.params.clone())
    # the state's adam moments and count carry on into the noised step
    qstep = make_train_step(model, probe, optimizer, qcfg)
    state, m = qstep(state, batch, gen)
    q_loss = m["loss"].item()
    # the same noised step without the probe, timed
    qstep = make_train_step(model, probe.criterion, optimizer, qcfg)
    t0 = time.perf_counter()
    state, m = qstep(state, batch, gen)
    q_loss_2 = m["loss"].item()
    q_ms = (time.perf_counter() - t0) * 1e3
    restored = bool(torch.equal(state.compute, state.params.to(state.compute.dtype)))
    log(f"quant-noise steps p={QUANT_NOISE_P}: the second {q_ms:.1f} ms (PCM-fed steps "
        f"{ms:.1f} ms), losses {q_loss} and {q_loss_2}; in the first, zeroed 8-block share "
        f"{probe.zero_share:.5f} over {len(probe.leaves)} noised leaves, masters untouched "
        f"{probe.masters_untouched}, compute copies restored {restored}")
    if not (math.isfinite(q_loss) and math.isfinite(q_loss_2)
            and abs(probe.zero_share - QUANT_NOISE_P) <= 0.01
            and probe.masters_untouched and restored):
        raise AssertionError("the quant-noise step failed its checks")
    return dict(ms_per_step=ms, frame_fed_ms_per_step=frame_ms, front_ms=front_ms,
                front_share=front_ms / ms, losses=losses, launches=counts,
                quant_noise=dict(ms=q_ms, losses=[q_loss, q_loss_2], zero_share=probe.zero_share,
                                 noised_leaves=len(probe.leaves)))


def run_long_utterances(dev) -> dict:
    """Utterances past the flagship's relative table (encoder_relative_max_size
    1024): the flagship's width at LONG_UTT's depth, an encoder pass in bf16
    (the table expanded, B1 once a layer; the output against the plain
    attention, ENCODER_ATOL) and a train step (B2 and B3 once a layer, the
    joint kernels once; finite loss and gradient norm)."""
    B, T, layers, U = LONG_UTT["B"], LONG_UTT["T_FRAMES"], LONG_UTT["LAYERS"], LONG_UTT["U"]
    V = FLAGSHIP["VOCAB"]
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, T, FLAGSHIP["FEAT"]), np.float32)
    lengths = np.array([T, 5 * T // 6], np.int32)[:B]
    model = flagship_model(dev, layers)
    table = model.encoder.rel_pos.max_size
    kernels = {**all_kernels(), **train_kernels()}
    for f in kernels.values():
        f.launches = 0
    batch = {"src_frames": torch.from_numpy(frames).to(dev, torch.bfloat16),
             "src_lengths": torch.from_numpy(lengths).to(dev)}
    with torch.no_grad():
        enc = model.encode(batch["src_frames"], batch["src_lengths"])
    torch.cuda.synchronize()
    counts = {name: f.launches for name, f in kernels.items() if f.launches}
    T_enc = enc.encoder_out.shape[1]
    if T_enc <= table or counts != {"rel_attention": layers}:
        raise AssertionError(f"long encoder pass T'={T_enc}: launches {counts}")
    err = compare_encoder(model, batch, sub=slice(0, B))
    out = {"T_enc": T_enc, "encoder_launches": counts, "encoder_max_abs_err": err}
    del model, enc
    torch.cuda.empty_cache()

    model = train_model(dev, TRAIN["DROPOUT"], layers)
    state, step = trainer(model)
    tb = {
        "src_frames": frames[None], "src_lengths": lengths[None],
        "prev_output_tokens": rng.integers(4, V, (1, B, U + 1)).astype(np.int32),
        "target": rng.integers(4, V, (1, B, U)).astype(np.int32),
        "tgt_lengths": np.full((1, B), U, np.int32), "weight": np.ones((1, B), np.float32),
    }
    tb = {k: torch.from_numpy(v).to(dev) for k, v in tb.items()}
    for f in kernels.values():
        f.launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    state, m = step(state, tb, gen)
    loss, gnorm = m["loss"].item(), m["gnorm"].item()
    counts = {name: f.launches for name, f in kernels.items() if f.launches}
    want = {"rel_attention_train_fwd": layers, "rel_attention_train_bwd": layers,
            "rnnt_joint_lp": 1, "rnnt_joint_bwd": 1}
    if counts != want or not (math.isfinite(loss) and math.isfinite(gnorm)) or m["overflow"].item():
        raise AssertionError(f"long train step: launches {counts} (want {want}), loss {loss}, "
                             f"gnorm {gnorm}")
    out.update(train_launches=counts, train_loss=loss, train_gnorm=gnorm)
    log(f"long utterances B={B} T={T} (T'={T_enc} past the table's {table}), {layers} layers: "
        f"{out}")
    del model, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the recipe's data path: manifest -> task -> iterator -> put_batch -> steps
# ---------------------------------------------------------------------------


def write_corpus(root: str, splits=None, units: int = CORPUS["UNITS"], seed: int = 0) -> dict:
    """A seeded WAV corpus under ``root``: ``{split}.json`` manifests with
    ``wave``, ``utt2num_frames`` and ``token_text`` for ``splits`` (split ->
    utterance count; CORPUS's 128 train and 32 valid by default), CORPUS's
    lengths and units a second, and a ``dict.txt`` of ``units`` units. The
    audio is int16 noise under a syllable-rate envelope plus a voiced tone.
    Returns per split the utterances, audio seconds and bytes written."""
    import json
    import os
    import wave

    splits = splits or {"train": CORPUS["TRAIN"], "valid": CORPUS["VALID"]}
    rate = CORPUS["RATE"]
    rng = np.random.default_rng(seed)
    vocab = [f"u{i:04d}" for i in range(units)]
    with open(os.path.join(root, "dict.txt"), "w") as f:
        f.writelines(f"{u} {units - i}\n" for i, u in enumerate(vocab))
    out = {}
    for split, n in splits.items():
        secs = np.clip(rng.normal(CORPUS["MEAN_S"], CORPUS["SD_S"], n), CORPUS["MIN_S"], CORPUS["MAX_S"])
        manifest, n_bytes = {}, 0
        for i, sec in enumerate(secs):
            S = int(sec * rate)
            t = np.arange(S) / rate
            env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t)
            pcm = env * (2500 * rng.standard_normal(S) + 3000 * np.sin(2 * np.pi * rng.uniform(90, 250) * t))
            pcm = np.clip(pcm, -32768, 32767).astype("<i2")
            utt = f"{split}_{i:04d}"
            path = os.path.join(root, f"{utt}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(rate)
                w.writeframes(pcm.tobytes())
            n_bytes += pcm.nbytes
            n_units = max(1, round(CORPUS["UNITS_PER_S"] * sec))
            manifest[utt] = {
                "wave": path,
                "utt2num_frames": str(1 + (S - WINDOW) // SHIFT),
                "token_text": " ".join(vocab[j] for j in rng.integers(0, units, n_units)),
            }
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump(manifest, f)
        out[split] = dict(utterances=n, audio_s=float(secs.sum()), bytes=n_bytes)
    return out


def write_global_cmvn(root: str, split: str = "train") -> str:
    """Global CMVN stats of the split's host fbank, as run.sh stage 2
    computes them: every utterance of the manifest read and framed on the
    host (``fbank_numpy``), mean and std accumulated in float64."""
    import os

    from espresso_tpu_torch.data.audio import read_audio
    from espresso_tpu_torch.data.manifest import load_manifest
    from espresso_tpu_torch.features.cmvn import compute_global_cmvn_stats
    from espresso_tpu_torch.features.fbank import fbank_numpy

    def feats():
        for e in load_manifest(root, split):
            wav, sr = read_audio(e.audio, e.kind)
            yield fbank_numpy(wav, sample_rate=sr)

    path = os.path.join(root, "cmvn.npz")
    np.savez(path, **compute_global_cmvn_stats(feats()))
    return path


def same_group(got: dict, want: dict) -> bool:
    """Two collated groups equal bit for bit: keys, arrays (dtype, shape,
    bytes) and the host entries."""
    if got.keys() != want.keys():
        return False
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            if not (isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
                    and g.tobytes() == w.tobytes()):
                return False
        elif g != w:
            return False
    return True


def group_shape(group: dict):
    """(B, T frames, U) of a collated waveform group."""
    S = group["src_waveforms"].shape[-1]
    return group["weight"].shape[-1], 1 + (S - WINDOW) // SHIFT, group["target"].shape[-1]


def run_recipe_data_path(dev, tmpdir: str, card: str) -> dict:
    """The flagship recipe from a WAV manifest, as a user drives it: a
    seeded corpus (write_corpus) with global CMVN from its train split; the
    recipe (RECIPE) through load_config_dict with the corpus, the stats and
    two spawn-process collate workers; setup_task, the 16-layer model on the
    card, the criterion, both splits. One epoch of the train split through
    task.get_batch_iterator (T x U buckets at max_tokens 590000) ->
    put_batch -> make_train_step: B10 once, B2 and B3 once a layer, B4 and
    B5 once a step, finite losses, no skipped update, no host sync in a
    step. A valid pass through make_valid_step, collated in process: B10,
    B1 once a layer and B4 a batch and no train kernel; one valid batch against the plain versions
    (TRAIN_LOSS_RTOL). The first two train groups of the spawn workers
    equal, bit for bit, those of an in-process iterator. Times the loader's
    wait, the collate, the host-to-card copies, the steps by bucket and the
    valid batches."""
    import os
    import pickle

    from espresso_tpu_torch.cli.train import put_batch
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused, fbank_plain
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train import trainer as tr

    root = os.path.join(tmpdir, "recipe")
    os.makedirs(root)
    t0 = time.perf_counter()
    corpus = write_corpus(root)
    cmvn = write_global_cmvn(root)
    log(f"recipe corpus {corpus}, CMVN stats from the train split: {time.perf_counter() - t0:.1f} s")

    cfg = load_config_dict(copy.deepcopy(RECIPE))
    cfg.dataset.data, cfg.dataset.global_cmvn_stats_path = root, cmvn
    cfg.dataset.num_workers, cfg.dataset.worker_backend = 2, "process"
    task = setup_task(cfg)
    torch.manual_seed(0)
    model = task.build_model(device=dev)
    criterion = task.build_criterion()
    train_ds, valid_ds = task.load_dataset("train"), task.load_dataset("valid")
    n_layers, V = len(model.encoder.layers), len(task.dictionary)
    optimizer, _ = tr.build_optimizer(cfg)
    state = tr.create_train_state(model, optimizer, cfg)
    step = tr.make_train_step(model, criterion, optimizer, cfg)
    valid = tr.make_valid_step(model, criterion, cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.common.seed)
    # the spawn pool takes the collater only if it pickles (else the
    # iterator would fall back to threads)
    pickle.dumps(train_ds.collate_group)

    def iterator(ds, **kw):
        return task.get_batch_iterator(ds, max_tokens=cfg.dataset.max_tokens,
                                       max_sentences=cfg.dataset.batch_size, seed=cfg.common.seed, **kw)

    kernels = {**train_kernels(), "fbank": fbank_fused, "rel_attention": ak.rel_attention}
    for f in kernels.values():
        f.launches = 0
    itr = iterator(train_ds, update_freq=cfg.optimization.update_freq[0])
    ev = lambda: torch.cuda.Event(enable_timing=True)
    steps, first, waits = [], [], []
    torch.cuda.synchronize()
    t_epoch = time.perf_counter()
    epoch = itr.next_epoch_itr()
    while True:
        t = time.perf_counter()
        group = next(epoch, None)
        waits.append(time.perf_counter() - t)
        if group is None:
            break
        if len(first) < 2:
            first.append(group)
        e = [ev() for _ in range(3)]
        e[0].record()
        batch = put_batch(group, dev)
        e[1].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        e[2].record()
        real = group["weight"] > 0
        steps.append((group_shape(group), e, m, int(real.sum()),
                      float(group["num_samples"][real].sum()) / CORPUS["RATE"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_epoch
    wait = sum(waits)
    n = len(steps)
    counts = {name: f.launches for name, f in kernels.items()}
    want = {"rel_attention_train_fwd": n_layers * n, "rel_attention_train_bwd": n_layers * n,
            "rnnt_joint_lp": n, "rnnt_joint_bwd": n, "fbank": n, "rel_attention": 0}
    if counts != want:
        raise AssertionError(f"recipe train epoch launches {counts}, want {want}")
    losses = torch.stack([m["loss"] for _, _, m, _, _ in steps]).tolist()
    overflow = torch.stack([m["overflow"] for _, _, m, _, _ in steps]).sum().item()
    if not all(math.isfinite(x) for x in losses) or overflow:
        raise AssertionError(f"recipe train losses {losses}, overflow {overflow}")
    by_bucket = {}
    for shape, e, _, utts, secs in steps:
        b = by_bucket.setdefault("x".join(map(str, shape)), dict(steps=0, step_ms=[], utterances=0))
        b["steps"] += 1
        b["step_ms"].append(e[1].elapsed_time(e[2]))
        b["utterances"] += utts
    copy_ms = [e[0].elapsed_time(e[1]) for _, e, _, _, _ in steps]
    train = dict(
        steps=n, utterances=sum(s[3] for s in steps), audio_s=sum(s[4] for s in steps),
        wall_s=wall, ms_per_step=wall / n * 1e3, loader_wait_s=wait, loader_wait_share=wait / wall,
        first_batch_wait_s=waits[0], later_wait_s=sum(waits[1:]), max_later_wait_s=max(waits[1:]),
        copy_ms_mean=statistics.mean(copy_ms), losses=losses, launches=counts, by_bucket=by_bucket,
    )
    log(f"recipe train epoch on {card}: {n} steps, {train['utterances']} utterances, "
        f"{train['audio_s']:.1f} s of audio in {wall:.2f} s ({train['ms_per_step']:.1f} ms a step); "
        f"the loader's wait {wait:.3f} s ({train['loader_wait_share']:.2%} of the epoch: "
        f"{waits[0]:.3f} s before the first batch, the two spawn workers' start included, "
        f"{sum(waits[1:]):.3f} s after it, at most {max(waits[1:]):.3f} s at once); "
        f"host-to-card copy {train['copy_ms_mean']:.3f} ms a batch; no host sync in a step; "
        f"launches {counts}; losses {losses}")
    for shape, b in sorted(by_bucket.items()):
        log(f"  bucket B x T x U = {shape}: {b['steps']} steps, {b['utterances']} utterances, "
            f"step ms {[round(x, 1) for x in b['step_ms']]}")

    # the valid pass, collated in process (the spawn pool is the train side's)
    for f in kernels.values():
        f.launches = 0
    cfg.dataset.num_workers = 0
    vitr = iterator(valid_ds, shuffle=False)
    vout, first_valid = [], None
    for group in vitr.next_epoch_itr():
        batch = put_batch(group, dev)
        for i in range(batch["weight"].shape[0]):
            mb = {k: v[i] for k, v in batch.items()}
            if first_valid is None:
                first_valid = mb
            e = [ev(), ev()]
            e[0].record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = valid(state, mb)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            e[1].record()
            vout.append((group_shape(group), e, out))
    torch.cuda.synchronize()
    nv = len(vout)
    counts = {name: f.launches for name, f in kernels.items()}
    want = {"rel_attention_train_fwd": 0, "rel_attention_train_bwd": 0, "rnnt_joint_lp": nv,
            "rnnt_joint_bwd": 0, "fbank": nv, "rel_attention": n_layers * nv}
    if counts != want:
        raise AssertionError(f"recipe valid launches {counts}, want {want}")
    v_loss = sum(o["loss"].item() for _, _, o in vout) / sum(o["sample_size"].item() for _, _, o in vout)
    valid_ms = [e[0].elapsed_time(e[1]) for _, e, _ in vout]
    # one valid batch through the plain versions
    k_loss = valid(state, first_valid)["loss"].item()
    plain = [(rk, "rnnt_joint_lp", rk.rnnt_joint_lp_reference), (tr, "fbank_fused", fbank_plain)]
    with plain_versions(), swapped(plain):
        p_loss = valid(state, first_valid)["loss"].item()
    rel = abs(k_loss - p_loss) / abs(p_loss)
    if not (math.isfinite(v_loss) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"recipe valid loss {v_loss}; a batch kernels {k_loss} vs plain {p_loss}")
    val = dict(batches=nv, shapes=[v[0] for v in vout], loss_per_sentence=v_loss, ms=valid_ms,
               launches=counts, sub_batch=dict(loss=k_loss, plain_loss=p_loss, rel_diff=rel))
    log(f"recipe valid pass on {card}: {nv} batches {val['shapes']}, valid ms {[round(x, 1) for x in valid_ms]}, "
        f"loss a sentence {v_loss}; launches {counts}; a batch kernels {k_loss} vs plain {p_loss} "
        f"({rel:.2e}, bound {TRAIN_LOSS_RTOL})")

    # the spawn workers' first two groups against an in-process iterator's
    itr0 = iterator(train_ds, update_freq=cfg.optimization.update_freq[0])
    specs = itr0._sharded_batches(1)[:4]
    t = time.perf_counter()
    for spec in specs:
        train_ds.collate_group(spec, 1)
    collate_ms = (time.perf_counter() - t) / len(specs) * 1e3
    epoch0 = itr0.next_epoch_itr()
    inproc = [next(epoch0) for _ in range(2)]
    if not all(same_group(a, b) for a, b in zip(first, inproc)):
        raise AssertionError("the spawn workers' batches differ from the in-process iterator's")
    log(f"recipe loader: the first two train groups equal bit for bit with 2 spawn workers and "
        f"with none; host collate {collate_ms:.1f} ms a batch (in-process, 4 batches); batches "
        f"planned by bucket_batches (numpy in both packages; the native batch_by_size serves "
        f"num_batch_buckets=0 only, so the phase builds no clib library)")
    return dict(corpus=corpus, vocab=V, layers=n_layers, train=train, valid=val,
                collate_ms=collate_ms, spawn_equals_in_process=True, card=card)


# the recipe's entry points (run_recipe_clis): the corpus's train and valid
# utterance counts, the epochs, the update of epoch 2 after which SIGTERM
# is raised, and the LM of the beam_lm point over the recipe's units
CLI_CORPUS = dict(train=32, valid=8)
CLI_EPOCHS = 2
CLI_SIGTERM_AFTER = 1


def encoded_frames(T: int, enc_cfg) -> int:
    """The encoder's output length for T input frames: each conv layer of
    the frontend maps T to (T + (k - 1) // 2 + k // 2 - k) // stride + 1."""
    for (kt, _), (st, _) in zip(enc_cfg.conv_kernel_sizes, enc_cfg.conv_strides):
        T = (T + (kt - 1) // 2 + kt // 2 - kt) // st + 1
    return T


def run_recipe_clis(dev, tmpdir: str, card: str) -> dict:
    """``recipe_clis`` with the CLIs' log lines (their handler writes to the
    stdout of the moment) on stderr beside this script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_clis(dev, tmpdir, card)


def recipe_clis(dev, tmpdir: str, card: str) -> dict:
    """The recipe as run.sh runs it, through the port's entry points at the
    flagship width (16 layers, d=512, V=5,004): stages 1-2 (``prep
    asr_prep_json`` from wav.scp and token-text files, ``prep
    text2vocabulary`` over the 5,000 units, global CMVN from the train
    split); stage 4 (``cli.train.main`` on the card for CLI_EPOCHS epochs
    with WER validation, SIGTERM raised after CLI_SIGTERM_AFTER updates of
    epoch 2 and a second ``main`` resuming from checkpoint_last, with
    asynchronous checkpoint writes); stage 5 (``average_checkpoints
    --num-epoch-checkpoints 2``, then ``speech_recognize`` from
    checkpoint_avg at beam 10, beta 2, gamma 2.3, and again fused with an
    LSTM LM written by the port's checkpoint module at lm_weight 0.47); the
    hub's ``transcribe`` on two WAVs against the CLI's hypotheses. Asserts
    every kernel's launches per train step, per valid batch and per decode
    batch, finite losses, the update count and iterator position after the
    resume, V = 5,004 and the four result files. Returns the recipe_cli
    numbers."""
    import contextlib as cl
    import io
    import json
    import logging
    import os
    import signal

    from espresso_tpu_torch import hub
    from espresso_tpu_torch.cli import average_checkpoints, prep, speech_recognize
    from espresso_tpu_torch.cli import train as train_cli
    from espresso_tpu_torch.config import config_to_dict
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import decode_kernels
    from espresso_tpu_torch.train import checkpoint as ckpt

    root = os.path.join(tmpdir, "recipe_cli")
    data, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpts")
    os.makedirs(data)
    secs = {}
    t0 = time.perf_counter()
    corpus = write_corpus(data, {"train": CLI_CORPUS["train"], "valid": CLI_CORPUS["valid"]})
    # the Kaldi data directories run.sh starts from: wav.scp, the BPE token
    # text, utt2num_frames, and the BPE model's unit inventory
    units = os.path.join(root, "units.txt")
    with open(units, "w") as f:
        f.writelines(f"u{i:04d}\n" for i in range(CORPUS["UNITS"]))
    for split in ("train", "valid"):
        with open(os.path.join(data, f"{split}.json")) as f:
            manifest = json.load(f)
        kdir = os.path.join(root, split)
        os.makedirs(kdir)
        for name, key in (("wav.scp", "wave"), ("token_text", "token_text"), ("utt2num_frames", "utt2num_frames")):
            with open(os.path.join(kdir, name), "w") as f:
                f.writelines(f"{u} {e[key]}\n" for u, e in manifest.items())
        os.remove(os.path.join(data, f"{split}.json"))
    os.remove(os.path.join(data, "dict.txt"))
    secs["corpus"] = time.perf_counter() - t0
    # stages 1-2
    t0 = time.perf_counter()
    for split in ("train", "valid"):
        kdir = os.path.join(root, split)
        prep.main(["asr_prep_json", "--wave-files", f"{kdir}/wav.scp", "--token-text-files",
                   f"{kdir}/token_text", "--utt2num-frames-files", f"{kdir}/utt2num_frames",
                   "--output", os.path.join(data, f"{split}.json")])
    with open(os.path.join(data, "test.json"), "w") as f, open(os.path.join(data, "valid.json")) as g:
        f.write(g.read())  # the decode split: the valid utterances
    out = io.StringIO()
    with cl.redirect_stdout(out):
        prep.main(["text2vocabulary", "--skip-ncols", "1", "--vocabsize", str(CORPUS["UNITS"]),
                   "--vocab", units, os.path.join(root, "train", "token_text")])
    with open(os.path.join(data, "dict.txt"), "w") as f:
        f.write(out.getvalue())
    cmvn = write_global_cmvn(data)
    secs["prep"] = time.perf_counter() - t0
    recipe = copy.deepcopy(RECIPE)
    recipe["dataset"].update(data=data, global_cmvn_stats_path=cmvn)
    recipe["checkpoint"]["save_dir"] = save_dir
    recipe["optimization"]["max_epoch"] = CLI_EPOCHS
    cfg_path = os.path.join(root, "recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    args = ["--config", cfg_path]
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.tasks import setup_task

    task = setup_task(load_config_dict(recipe))
    V, enc_cfg = len(task.dictionary), task.build_model_config()[1].encoder
    layers = enc_cfg.encoder_layers
    if V != CORPUS["UNITS"] + 4:  # the units and <s> (blank), <pad>, </s>, <unk>
        raise AssertionError(f"the prepared dictionary gives V = {V}")
    del task
    log(f"recipe CLIs: corpus {corpus}; prep {secs['prep']:.1f} s; V = {V}, {layers} layers")

    # stage 4: train, SIGTERM in epoch 2, resume
    train_k = {**train_kernels(), "fbank": fbank_fused, "rel_attention": ak.rel_attention}
    for f in train_k.values():
        f.launches = 0
    ev = lambda: torch.cuda.Event(enable_timing=True)
    rec = dict(steps=0, epoch_steps=[0], step_events=[], valid_batches=0, valid_s=[], saves=[],
               copies=[], losses=[])
    make_step, make_valid, validate = train_cli.make_train_step, train_cli.make_valid_step, train_cli.validate

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen):
            e = [ev(), ev()]
            e[0].record()
            state, m = step(state, batch, gen)
            e[1].record()
            rec["steps"] += 1
            rec["epoch_steps"][-1] += 1
            rec["step_events"].append(e)
            rec["losses"].append(m["loss"])
            if len(rec["epoch_steps"]) == 2 and rec["epoch_steps"][-1] == CLI_SIGTERM_AFTER \
                    and not rec.get("sigterm"):
                rec["sigterm"] = True
                signal.raise_signal(signal.SIGTERM)
            return state, m
        return run

    def counted_valid(*a, **kw):
        valid = make_valid(*a, **kw)

        def run(state, mb):
            rec["valid_batches"] += 1
            return valid(state, mb)
        return run

    def timed_validate(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = validate(*a, **kw)
        rec["valid_s"].append(time.perf_counter() - t)
        rec["epoch_steps"].append(0)
        rec["wer"] = stats.get("wer")
        return stats

    save, arrays = ckpt.save_checkpoint_state, ckpt.train_state_arrays

    def timed_save(path, state, host_state, async_write=False):
        t = time.perf_counter()
        save(path, state, host_state, async_write)
        rec["saves"].append((os.path.basename(path), async_write, time.perf_counter() - t))

    def timed_arrays(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_ = arrays(*a, **kw)
        rec["copies"].append(time.perf_counter() - t)
        return out_

    patches = [(train_cli, "make_train_step", counted_step), (train_cli, "make_valid_step", counted_valid),
               (train_cli, "validate", timed_validate), (ckpt, "save_checkpoint_state", timed_save),
               (ckpt, "train_state_arrays", timed_arrays)]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        t0 = time.perf_counter()
        train_cli.main(args, device=dev)
        secs["train_until_sigterm"] = time.perf_counter() - t0
        if not rec.get("sigterm"):
            raise AssertionError("the train CLI ran no update of epoch 2")
        tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
        n1 = rec["epoch_steps"][0]
        want_it = {"epoch": 2, "iterations_in_epoch": CLI_SIGTERM_AFTER}
        if int(tree["step"]) != n1 + CLI_SIGTERM_AFTER or any(host["iterator"][k] != v for k, v in want_it.items()):
            raise AssertionError(f"SIGTERM checkpoint: step {int(tree['step'])}, iterator {host['iterator']}; "
                                 f"want {n1 + CLI_SIGTERM_AFTER} and {want_it}")
        sigterm_state = dict(step=int(tree["step"]), host_state=host)
        del tree
        t0 = time.perf_counter()
        stats = train_cli.main(args + ["checkpoint.write_checkpoints_asynchronously=true"], device=dev)
        secs["train_resumed"] = time.perf_counter() - t0
    finally:
        for mod, name, _ in patches:
            setattr(mod, name, {"make_train_step": make_step, "make_valid_step": make_valid,
                                "validate": validate, "save_checkpoint_state": save,
                                "train_state_arrays": arrays}[name])
    torch.cuda.synchronize()
    n, nv = rec["steps"], rec["valid_batches"]
    # a step: B10, B2 and B3 a layer, B4, B5; a valid batch: the valid step
    # (B10, B1 a layer, B4) and the greedy WER decode (B10, B1 a layer)
    train_counts = {name: f.launches for name, f in train_k.items()}
    want = {"rel_attention_train_fwd": layers * n, "rel_attention_train_bwd": layers * n,
            "rnnt_joint_lp": n + nv, "rnnt_joint_bwd": n, "fbank": n + 2 * nv,
            "rel_attention": 2 * layers * nv}
    if train_counts != want:
        raise AssertionError(f"recipe CLI train launches {train_counts}, want {want} ({n} steps, "
                             f"{nv} valid batches)")
    losses = torch.stack(rec["losses"]).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recipe CLI train losses {losses}")
    tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
    if int(tree["step"]) != n or host["iterator"]["epoch"] != CLI_EPOCHS + 1 \
            or host["iterator"]["iterations_in_epoch"] != 0:
        raise AssertionError(f"after the resume: step {int(tree['step'])} of {n}, iterator {host['iterator']}")
    del tree
    names = sorted(os.listdir(save_dir))
    for name in ("checkpoint1", "checkpoint2", "checkpoint_best", "checkpoint_last", "model_cfg.json"):
        if name not in names:
            raise AssertionError(f"{name} missing from {names}")
    step_ms = [e[0].elapsed_time(e[1]) for e in rec["step_events"]]
    size = lambda name: sum(os.path.getsize(os.path.join(save_dir, name, f))
                            for f in os.listdir(os.path.join(save_dir, name)))
    log(f"recipe CLI train on {card}: {n} steps ({rec['epoch_steps']} by epoch and resume), "
        f"{nv} valid batches, step ms {[round(x, 1) for x in step_ms]}, valid s {rec['valid_s']}, "
        f"WER {rec.get('wer')}; SIGTERM checkpoint {sigterm_state}; launches {train_counts}; saves "
        f"{[(a, b, round(c, 3)) for a, b, c in rec['saves']]}; device-to-host copies {rec['copies']} s; "
        f"checkpoint {size('checkpoint_last')} bytes; {stats}")

    # stage 5: average, decode with and without the LM, the hub
    t0 = time.perf_counter()
    average_checkpoints.main(["--inputs", save_dir, "--num-epoch-checkpoints", "2",
                              "--output", os.path.join(save_dir, "checkpoint_avg")])
    secs["average"] = time.perf_counter() - t0
    lm_dir = os.path.join(root, "lm")
    os.makedirs(lm_dir)
    lm_cfg = LSTMLMConfig(**{**LM, "vocab_size": V - 1})
    torch.manual_seed(1)
    lm = LSTMLanguageModel(lm_cfg)
    ckpt.save_checkpoint_state(os.path.join(lm_dir, "checkpoint_last"),
                               ckpt.flatten_tree({"params": ckpt.flax_variables(lm)["params"]}), {})
    with open(os.path.join(lm_dir, "model_cfg.json"), "w") as f:
        json.dump({"model_name": "LSTMLanguageModel", "name": lm_cfg.name, "criterion": "cross_entropy",
                   "config": config_to_dict(lm_cfg)}, f, indent=2)
    del lm
    dec_args = args + ["checkpoint.restore_file=checkpoint_avg", "generation.beam=10",
                       "generation.expansion_beta=2", "generation.expansion_gamma=2.3",
                       "dataset.gen_subset=test"]
    decode_calls = []
    run_async = TransducerBeamSearchDecoder.decode_async

    def recorded(self, batch):
        decode_calls.append(int(batch["src_frames"].shape[1]))
        return run_async(self, batch)

    class Elapsed(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Recognized"):
                rec["elapsed"] = record.args[1]

    handler = Elapsed()
    logging.getLogger("espresso_tpu_torch.recognize").addHandler(handler)
    decodes = {}
    R = BEAM["max_num_expansions_per_step"] + 1
    audio_s = corpus["valid"]["audio_s"]
    try:
        TransducerBeamSearchDecoder.decode_async = recorded
        for tag, extra in (("beam", []), ("beam_lm", [f"generation.lm_path={lm_dir}",
                                                      f"generation.lm_weight={LM_WEIGHT}"])):
            out_dir = os.path.join(root, f"decode_{tag}")
            kernels = {**all_kernels(), "fbank": fbank_fused}
            for f in kernels.values():
                f.launches = 0
            decode_calls.clear()
            t0 = time.perf_counter()
            res = speech_recognize.main(dec_args + extra + [f"generation.results_path={out_dir}"], device=dev)
            torch.cuda.synchronize()
            secs[f"decode_{tag}"] = time.perf_counter() - t0
            counts = {name: f.launches for name, f in kernels.items()}
            t_enc = sum(encoded_frames(T, enc_cfg) for T in decode_calls)
            nb = len(decode_calls)
            want = {"rel_attention": layers * nb, "fused_joint_topk": R * t_enc,
                    "lstm_step_reorder": (2 if extra else 1) * (R - 1) * t_enc,
                    "aes_merge": R * t_enc, "aes_backtrace": nb, "fbank": nb}
            if counts != want:
                raise AssertionError(f"recipe CLI {tag} decode launches {counts}, want {want}")
            files = sorted(os.listdir(out_dir))
            if files != ["aligned_results.txt", "cer", "decoded_results.txt", "wer"] \
                    or res["num_utts"] != CLI_CORPUS["valid"]:
                raise AssertionError(f"recipe CLI {tag} decode: files {files}, result {res}")
            decodes[tag] = dict(result=res, batches=nb, launches=counts, elapsed_s=rec["elapsed"],
                                rtfx=audio_s / rec["elapsed"],
                                wer_file=open(os.path.join(out_dir, "wer")).read().strip())
            log(f"recipe CLI {tag} decode on {card}: {res}, {nb} batches in {rec['elapsed']:.3f} s, "
                f"RTFx {audio_s / rec['elapsed']:.1f}; launches {counts}; {decodes[tag]['wer_file']}")
    finally:
        TransducerBeamSearchDecoder.decode_async = run_async
        logging.getLogger("espresso_tpu_torch.recognize").removeHandler(handler)

    # the hub on two of the test WAVs against the CLI's beam hypotheses
    t0 = time.perf_counter()
    with open(os.path.join(data, "test.json")) as f:
        test = json.load(f)
    utts = sorted(test)[:2]
    asr = hub.from_pretrained(save_dir, data_dir=data, beam=10, device=dev, **{
        "checkpoint.restore_file": "checkpoint_avg", "dataset.feature_type": "device_fbank",
        "dataset.global_cmvn_stats_path": cmvn, "generation.expansion_beta": 2,
        "generation.expansion_gamma": 2.3})
    got = asr.transcribe([test[u]["wave"] for u in utts])
    secs["hub"] = time.perf_counter() - t0
    cli = {}
    with open(os.path.join(root, "decode_beam", "decoded_results.txt")) as f:
        for line in f:
            u, _, hyp = line.rstrip("\n").partition(" ")
            cli[u] = hyp
    if got != [cli[u] for u in utts]:
        raise AssertionError(f"hub {got} != the CLI's {[cli[u] for u in utts]}")
    log(f"recipe CLI hub: {utts} -> {got}, the CLI's hypotheses")
    del asr
    torch.cuda.empty_cache()
    return dict(
        corpus=corpus, vocab=V, layers=layers, stage_s=secs, steps=n, steps_by_epoch=rec["epoch_steps"],
        train_ms_per_step=statistics.mean(step_ms), step_ms=step_ms, valid_batches=nv,
        valid_ms_per_batch=sum(rec["valid_s"]) / nv * 1e3, valid_wer=rec.get("wer"), losses=losses,
        sigterm=sigterm_state, train_launches=train_counts,
        checkpoint_bytes=size("checkpoint_last"), device_to_host_s=rec["copies"],
        saves=[dict(name=a, async_write=b, s=c) for a, b, c in rec["saves"]], decodes=decodes,
        hub=dict(utts=utts, hyps=got), card=card,
    )


def compare_train_step(dev) -> dict:
    """One step of a 2-utterance sub-batch at dropout 0 from one init,
    through the kernels and through the plain versions: the loss and the
    gradient norm within their bounds, and every parameter's bf16 gradient
    within TRAIN_LEAF_GRAD_REL and TRAIN_LEAF_SCALE of the plain one."""
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import rnnt_kernels as rk

    model = train_model(dev, 0.0)
    ref_model = copy.deepcopy(model)
    batch = train_batch(dev, 2)
    state, step = trainer(model)
    state, m = step(state, batch)
    ref_state, ref_step = trainer(ref_model)
    plain = [
        (ak, "rel_attention_train_fwd",
         lambda qu, qv, k, v, p, kv, seed, H_, sc, rate:
         ak.rel_attention_train_reference(qu, qv, k, v, p, kv, H_, sc, rate, seed)),
        (ak, "rel_attention_train_bwd",
         lambda qu, qv, k, v, p, kv, seed, g, H_, sc, rate:
         ak.rel_attention_train_backward_reference(qu, qv, k, v, p, kv, g, H_, sc, rate, seed)),
        (rk, "rnnt_joint_lp", rk.rnnt_joint_lp_reference),
        (rk, "rnnt_joint_bwd", rk.rnnt_joint_bwd_reference),
    ]
    with swapped(plain):
        ref_state, rm = ref_step(ref_state, batch)
    loss, ref_loss = m["loss"].item(), rm["loss"].item()
    gnorm, ref_gnorm = m["gnorm"].item(), rm["gnorm"].item()
    names = [n for n, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]
    g, rg = state.grads.float(), ref_state.grads.float()
    leaves, scales, n_zero = [], [], 0
    for name, gl, rl in zip(names, g.split(sizes), rg.split(sizes)):
        if TRAIN_ZERO_GRAD.search(name):
            n_zero += 1
            continue
        leaves.append(((gl - rl).norm().item() / rl.norm().item(), name))
        scales.append((abs(((gl - rl) @ rl).item()) / (rl @ rl).item(), name))
    leaves.sort(reverse=True)
    scales.sort(reverse=True)
    out = dict(
        loss=loss, plain_loss=ref_loss, loss_rel_diff=abs(loss - ref_loss) / abs(ref_loss),
        gnorm=gnorm, plain_gnorm=ref_gnorm, gnorm_rel_diff=abs(gnorm - ref_gnorm) / ref_gnorm,
        worst_leaf_grad_rel_diff=leaves[0][0], worst_leaf=leaves[0][1],
        median_leaf_grad_rel_diff=leaves[len(leaves) // 2][0],
        worst_leaf_scale_diff=scales[0][0], worst_scale_leaf=scales[0][1],
        leaves_checked=len(leaves), leaves_zero_in_exact_arithmetic=n_zero,
    )
    log(f"train step sub-batch kernels vs plain: {out} (bounds: loss {TRAIN_LOSS_RTOL}, "
        f"gnorm {TRAIN_GNORM_RTOL}, each leaf's gradient {TRAIN_LEAF_GRAD_REL} and scale "
        f"{TRAIN_LEAF_SCALE}); worst leaves: "
        f"{leaves[:8]}; worst scales: {scales[:8]}")
    if not (out["loss_rel_diff"] <= TRAIN_LOSS_RTOL and out["gnorm_rel_diff"] <= TRAIN_GNORM_RTOL
            and leaves[0][0] <= TRAIN_LEAF_GRAD_REL and scales[0][0] <= TRAIN_LEAF_SCALE):
        raise AssertionError(f"train step kernels vs plain versions disagree: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA card available")
        return 1
    from espresso_tpu_torch.ops.backend import require_cuda

    t_start = time.perf_counter()
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    nvcc_log = build_kernels()
    log(f"kernel build {time.perf_counter() - t0:.2f} s (libraries in parallel)\n{nvcc_log}")

    def phase(name: str) -> None:
        log(f"-- {name} at {time.perf_counter() - t_start:.1f} s")

    phase("attention kernel checks")
    rows = {"rel_attention": check_attention(dev)}
    for check in (check_decode_kernels, check_train_kernels, check_front_kernels):
        phase(check.__name__)
        rows.update(check(dev))
    tmp = tempfile.TemporaryDirectory()
    phase("serving paths")

    model = flagship_model(dev)
    batch = flagship_batch(dev)
    with torch.no_grad():
        T_enc = model.encode(batch["src_frames"][:1], batch["src_lengths"][:1]).encoder_out.shape[1]
        enc_ms = median_ms(lambda: model.encode(batch["src_frames"], batch["src_lengths"]), samples=3, reps=1)
    greedy = run_greedy(model, batch, dev, enc_ms)
    beam = run_beam(model, batch, dev, enc_ms, T_enc)
    greedy["encoder_max_abs_err"] = compare_encoder(model, batch)
    beam["sub_batch"] = compare_beam(model, batch)
    beam_pcm = run_beam_from_pcm(model, dev, tmp.name, beam["wall_s"] / 3 * 1e3,
                                 {k: v // 3 for k, v in beam["launches"].items()})
    phase("beam_lm")
    lm = lm_model(dev)
    beam_lm = run_beam_lm(model, lm, batch, dev, enc_ms, T_enc)
    beam_lm["sub_batch"] = compare_beam(model, batch, lm)
    print(json.dumps({"greedy": greedy, "beam": beam, "beam_from_pcm": beam_pcm,
                      "beam_lm": beam_lm, "card": card}))
    del model, batch, lm
    torch.cuda.empty_cache()

    phase("train paths")
    train = run_train(dev)
    train["sub_batch"] = compare_train_step(dev)
    torch.cuda.empty_cache()
    train_pcm = run_train_from_pcm(dev, tmp.name, train["ms_per_step"])
    torch.cuda.empty_cache()
    phase("recipe data path")
    recipe = run_recipe_data_path(dev, tmp.name, card)
    tmp.cleanup()
    torch.cuda.empty_cache()
    phase("recipe CLIs")
    with tempfile.TemporaryDirectory() as cli_tmp:
        recipe_cli = run_recipe_clis(dev, cli_tmp, card)
    print(json.dumps({"recipe_cli": recipe_cli}))
    torch.cuda.empty_cache()
    phase("long utterances")
    long_utt = run_long_utterances(dev)
    print(json.dumps({"train": train, "train_from_pcm": train_pcm, "recipe_data_path": recipe,
                      "long_utterances": long_utt, "card": card}))

    sources = {
        "rel_attention": ("rel_attention.cu", "espresso_tpu/ops/attention_kernels.py:185"),
        "fused_joint_topk": ("fused_joint_topk.cu", "espresso_tpu/ops/decode_kernels.py:92"),
        "lstm_step_reorder": ("lstm_step_reorder.cu", "espresso_tpu/ops/decode_kernels.py:485"),
        "aes_merge": ("aes_merge.cu", "espresso_tpu/ops/decode_kernels.py:718"),
        "aes_backtrace": ("aes_backtrace.cu", "espresso_tpu/ops/decode_kernels.py:307"),
        "rel_attention_train_fwd": (
            "rel_attention_train.cu", "espresso_tpu/ops/attention_kernels.py:578"),
        "rel_attention_train_bwd": (
            "rel_attention_train.cu", "espresso_tpu/ops/attention_kernels.py:617"),
        "rnnt_joint_lp": ("rnnt_joint_lp.cu", "espresso_tpu/ops/rnnt_pallas.py:83"),
        "rnnt_joint_bwd": ("rnnt_joint_bwd.cu", "espresso_tpu/ops/rnnt_pallas.py:211"),
        "fbank": ("fbank.cu", "espresso_tpu/features/pallas_fbank.py:177"),
        "int8_matmul": ("int8_matmul.cu", "espresso_tpu/ops/quantization.py:141"),
    }
    # each kernel's launches on the path that runs it: fbank's in the
    # PCM-fed serving batch (the PCM-fed train steps launch it once a step);
    # int8_matmul lies on no path
    launches = {**beam["launches"], **train["launches"], "fbank": beam_pcm["launches"]["fbank"],
                "int8_matmul": 0}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        extra = {"reason": "no caller in either package"} if name == "int8_matmul" else {}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"espresso_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # no single PyTorch call computes any of these functions (for
            # int8_matmul, torch._int_mm covers only the int8 product)
            "library_ms": None,
            # yardsticks, not library calls for the function: B4's, B5's, B6's
            # and B7's products alone through cuBLAS, scaled_dot_product_attention's
            # forward beside B1, with dropout beside B2 and backward beside B3,
            # cuFFT's rfft beside B10, torch._int_mm beside B11; B3's and B5's
            # whole device time a call, B10 at the train point, B8's wrapper
            # host time a call, B11's row pass and product apart
            **{k: r[k] for k in ("cublas_products_ms", "sdpa_fwd_ms", "sdpa_fwd_dropout_ms",
                                 "sdpa_bwd_ms",
                                 "ms_all_kernels", "cufft_ms", "train_ms", "train_bound_ms",
                                 "host_us", "unfused_host_us", "int_mm_ms", "row_pass_ms",
                                 "product_ms", "second_shape") if k in r},
            # the shapes later slices added: the long-row mode (B1, B2; B3
            # at the same lengths), the wide joint (B6), 8 to 96 kHz (B10),
            # the beam_lm point's calls (B6 with a label bias, B7's LM
            # instance) and the launches of its batches (B6-B9)
            **{k: r[k] for k in r if k.split("_")[0] in ("long", "wide", "lm")
               or k.startswith("khz")},
            **({"beam_lm_launches": beam_lm["launches"][name]}
               if name in beam_lm["launches"] else {}),
            # the recipe data path's train epoch and valid pass
            **({"recipe_train_launches": recipe["train"]["launches"][name],
                "recipe_valid_launches": recipe["valid"]["launches"][name]}
               if name in recipe["train"]["launches"] else {}),
            # the recipe CLIs: the train CLI's runs (steps and valid passes),
            # the beam and beam_lm decodes through speech_recognize
            **({"recipe_cli_train_launches": recipe_cli["train_launches"][name]}
               if name in recipe_cli["train_launches"] else {}),
            **{f"recipe_cli_{tag}_launches": d["launches"][name]
               for tag, d in recipe_cli["decodes"].items() if name in d["launches"]},
            **extra,
        })
    log(f"chip_smoke {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
