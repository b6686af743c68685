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
   ``beam_lm`` point's LM, embed 512 gate-padded to H=1024, L=3, and at
   the recipe's LM, 4 x 800 gate-padded to Hp=832, at BK=2560 and 12, each
   timed beside its bound; ``fbank`` also at 22.05, 44.1 (an odd shift), 48, 96, 176.4,
   192, 352.8 and 384 kHz, the 1024- to 8192-point instances and the large
   instance, at edge counts and at a batch of the serving batch's audio
   seconds; ``fbank`` and its plain version each against the function in
   float64 on the card at 16, 8 and 384 kHz), and times kernel and plain
   version at
   the flagship shape (and, beside B5, B6 and B7, their products alone
   through cuBLAS as a yardstick, beside B1 the forward of
   ``scaled_dot_product_attention``, beside B2 its forward with dropout,
   beside B3 its backward, beside B10 cuFFT's ``rfft`` of the
   valid frames alone; for B3 and B5 also every kernel the call runs and
   the split by kernel; for B8 the wrapper's host time a call); B5 twice
   on the same inputs at the flagship and at V = 5,003, all four outputs
   bit for bit (its partial sums in slots, summed in a fixed order);
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
8. runs the recipe's LM stage (``run_recipe_lm``, run.sh's stage 3):
   ``prep text2vocabulary`` and ``prep binarize`` of a seeded 4,500 +
   300 sentence corpus of the 5,000 units, ``cli.train.main`` of
   ``lstm_lm_librispeech`` (4 x 800, V = 5,003) for one epoch from the
   ``.bin`` stream with its valid pass, ``cli.eval_lm.main`` on the valid
   split (within 0.5 % of the CLI's valid nll), two fp32 LM train steps
   on the card against the CPU; no kernel launched; prints the
   ``recipe_lm`` JSON line;
9. runs the recipe through the port's entry points (``run_recipe_clis``,
   run.sh's stages): ``prep asr_prep_json`` and ``text2vocabulary`` over a
   seeded 32 + 8 utterance WAV corpus (V = 5,004), ``cli.train.main`` for
   2 epochs at the flagship width (8 layers) with WER validation, SIGTERM
   raised after the first update of epoch 2 and a second ``main`` resuming
   from checkpoint_last (asynchronous checkpoint writes),
   ``average_checkpoints --num-epoch-checkpoints 2``, ``speech_recognize``
   from checkpoint_avg at beam 10 and again fused with the LM the LM stage
   trained (B7 on its stack at Hp = 832, L = 4), and the hub's
   ``transcribe`` against ``speech_recognize`` on the same inputs; every
   kernel's launches per step, valid batch and decode batch asserted; one
   test WAV decoded alone at two paddings (bf16 on the card, fp32 on the
   CPU) and the train CLI run twice from one seed for 3 updates, every
   parameter bit-equal after every update or the script fails
   (``train_reproducibility``); prints the ``recipe_cli`` JSON line;
10. runs the LSTM attention encoder-decoder's recipe (``run_recipe_lstm``,
   ``lstm_librispeech.yaml``) at ``speech_conv_lstm_librispeech``'s full
   width on a seeded 40 + 8 utterance WAV corpus through the front (B10):
   ``cli.train.main`` for an epoch with its greedy WER validation, a
   second ``main`` resuming for epoch 2, two fp32 train steps card against
   CPU, ``speech_recognize`` at beam 60 alone and fused with the LM the LM
   stage trained (no host sync while a batch is launched), a
   2-utterance fp32 beam_lm decode of a seeded model card against CPU
   (the n-best rank by rank), and one encoder layer's forward and backward
   with separate and with flattened weights (``time_lstm_weight_compaction``);
   B10's launches asserted; prints the ``recipe_lstm`` JSON line;
11. runs the transformer encoder-decoder's recipe (``run_recipe_transformer``,
   ``transformer_librispeech.yaml``) at ``speech_transformer_librispeech``'s
   full width (12 transformer encoder layers with relative positions, 6
   decoder layers, d 512, tied embedding) on a seeded 56 + 8 utterance WAV
   corpus through the front: ``cli.train.main`` for an epoch (update_freq
   8) with its greedy WER validation, a second ``main`` resuming for epoch
   2, two fp32 train steps card against CPU, every B1, B2 and B3 call of an
   encoder pass and a train step held against its plain version in situ,
   ``speech_recognize`` at beam 60 alone and fused at 0.4 with the LM the
   LM stage trained (no host sync while a batch is launched), a 2-utterance
   fp32 beam_lm decode of a seeded model card against CPU; the launches of
   B1, B2, B3 and B10 asserted; prints the ``recipe_transformer`` JSON line;
12. runs the Transformer-CTC recipe (``run_recipe_transformer_ctc``,
   ``transformer_ctc_librispeech.yaml``) at ``transformer_ctc_librispeech``'s
   full width (12 transformer encoder layers with relative positions, d
   512, ``fc_out`` to V = 5,004) on the same corpus: ``cli.train.main``
   (update_freq 4) with its greedy WER validation, SIGTERM in epoch 2 and
   a resume, the train CLI twice from one seed bit for bit, two fp32 train
   steps card against CPU, B1, B2 and B3 held in situ, ``speech_recognize``
   with the prefix beam at beam 10 alone and with the LM (the same
   hypotheses: the search never reads it; no host sync while a batch is
   launched), the hub against ``speech_recognize``, a seeded fp32 prefix
   beam card against CPU; the launches of B1, B2, B3 and B10 asserted;
   prints the ``recipe_transformer_ctc`` JSON line;
13. encodes and trains 2 layers of the flagship on utterances past its
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
# the recipe's fusion LM (examples/asr_librispeech/run.sh:61-77): JAX's
# lstm_lm_librispeech preset (models/lstm_lm.py:106-112), trained by the
# "recipe LM stage" phase; B7 runs it at Hp = 832
LM_RECIPE = dict(embed_dim=800, hidden_size=800, out_embed_dim=800, num_layers=4, dropout=0.0)
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


def lstm_lm_instance(dev, B: int, K: int, E: int, H: int, L: int) -> dict:
    """B7 on an LM's gate-padded stack at BK = B K, timed beside its plain
    version, its bound and cuBLAS on its products. The bound counts the LM
    step, not the padded stack: layer 0's products at width E + H, the
    others' at 2H, the weights and the embedded tokens at their unpadded
    sizes; the padded stack's products (layer 0 at 2 Hp, its zero columns
    multiplied too) are reported beside it as padded_gflop."""
    from espresso_tpu_torch.ops import decode_kernels as dk
    from espresso_tpu_torch.ops import kernel_checks as kc

    BK = B * K
    s = kc.lstm_lm_inputs(B, K, E, H, L, seed=B + 7, dev=dev)
    k_rows = (E + H) + (L - 1) * 2 * H  # the rows of the step's gate kernels
    n_bytes = (BK * E + 2 * BK * 2 * L * H + k_rows * 4 * H) * 2 + L * 4 * H * 4 + BK * 9
    flops = 2 * BK * k_rows * 4 * H
    out = dict(zip(("bound_ms", "bound_by"), bound(n_bytes, flops, PEAK_BF16)))
    Hp = s["w_ih"].shape[1]
    out["Hp"] = Hp
    out["padded_gflop"] = L * 2 * BK * 2 * Hp * 4 * Hp / 1e9
    t = time_pair(
        f"lstm_step_reorder LM instance H={H} L={L}", lambda: dk.lstm_step_reorder(**s, B=B, K=K),
        lambda: dk.lstm_step_reorder_reference(**s, B=B, K=K), "", per_call=L,
    )
    out["ms"], out["plain_ms"] = t["ms"], t["plain_ms"]
    xa = torch.cat([s["x"], s["S"][s["src"], :Hp]], 1)  # layer 0's padded input
    wa = torch.cat([s["w_ih"][0], s["w_hh"][0]], 0).contiguous()
    out["cublas_products_ms"] = device_ms(lambda: [xa @ wa for _ in range(L)])
    log(f"lstm_step_reorder LM instance BK={BK} E={E} H={H} (Hp {Hp}) L={L}: {out['ms']} ms, bound "
        f"{out['bound_ms']} ms ({out['bound_by']}, {flops / 1e9:.1f} GFLOP the step needs; the padded "
        f"stack's products {out['padded_gflop']:.1f} GFLOP), cuBLAS products {out['cublas_products_ms']} ms")
    return out


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
    # then the recipe's trained LM (lstm_lm_librispeech: 4 x 800, padded to
    # Hp = 832, 13 column tiles of 64), which the recipe CLIs' beam_lm
    # decode runs. Each is timed at BK = 2560 beside its bound and cuBLAS on
    # its products (a layer's [BK, 2H] . [2H, 4H], L times)
    for prefix, cfg in (("lm", LM), ("lm_recipe", LM_RECIPE)):
        E_lm, H_lm, L_lm = cfg["embed_dim"], cfg["hidden_size"], cfg["num_layers"]
        errs += [kc.check_lstm(kc.lstm_lm_inputs(Bx, Kx, E_lm, H_lm, L_lm, seed=Bx + 7, dev=dev), Bx, Kx)
                 for Bx, Kx in ((B, K), (1, 12))]
        log(f"lstm_step_reorder {prefix} instance (E {E_lm}, H {H_lm}, L {L_lm}) max_abs_err "
            f"{errs[-2:]} (bound {kc.LSTM_TOL})")
        row.update({f"{prefix}_{k}": v for k, v in lstm_lm_instance(dev, B, K, E_lm, H_lm, L_lm).items()})
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
    # the wrapper's whole device time and the split by kernel (the query
    # pass, the dp bands' sum and the key pass); a yardstick of the order of
    # size, not the same function:
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
    # B5's sums in a fixed order: two launches bit-equal in all four outputs
    # at the flagship and at V = 5003
    for B, T, U, V, blank in RNNT_SHAPES[:2]:
        tc.check_rnnt_joint_bwd_repeats(tc.rnnt_inputs(B, T, U, 512, V, seed=V + T, dev=dev,
                                                       blank=blank), blank)
        log(f"rnnt_joint_bwd B={B} T'={T} U={U} V={V}: two launches bit-equal")
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
    # the wrapper's whole device time (the slots' sum included) and the
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
    # which side errs (ROADMAP queue C item 2): the kernel and the card's
    # plain version each against the function in float64 on the card, at the
    # serving batch (16 kHz), 8 kHz and the large instance's 384 kHz
    sources = {"khz16": fc.fbank_error_sources(a)}
    sources["khz8"] = fc.fbank_error_sources(a8, sample_rate=8000.0)
    for nums, S_edge in dict(FBANK_RATES)[384000.0]:
        ae = fc.waveform_inputs(nums, S_edge, seed=S_edge, dev=dev, sample_rate=384000.0)
        sources[f"khz384_S{S_edge}"] = fc.fbank_error_sources(ae, sample_rate=384000.0)
    log(f"fbank log errors on the loud bins against the float64 function on the card: {sources} (bound "
        f"{fc.FBANK_LOG_TOL}, the kernel's)")
    rows["fbank"] = dict(row, max_abs_err=max(e["log"] for e in errs), valid_frames=valid,
                         linear_err=max(e["linear"] for e in errs), f64_error_sources=sources)
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
            encoder_layer_type="conformer", encoder_pos_type="relative",
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
            encoder_layer_type="conformer", encoder_pos_type="relative",
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


def prep_recipe_data(root: str, data: str, splits: dict, seed: int = 0):
    """Stages 1-2 of run.sh through the port's ``prep``: a seeded WAV corpus
    (``write_corpus``) turned into the Kaldi data directories run.sh starts
    from (wav.scp, the BPE token text, utt2num_frames, and the BPE model's
    unit inventory), then ``prep asr_prep_json`` for each split and ``prep
    text2vocabulary`` over the train split's units into ``data``, the
    valid split copied as ``test``, and the global CMVN. Returns (the
    corpus, the CMVN path, seconds of the corpus and of prep)."""
    import contextlib as cl
    import io
    import json
    import os

    from espresso_tpu_torch.cli import prep

    t0 = time.perf_counter()
    corpus = write_corpus(data, splits, seed=seed)
    units = os.path.join(root, "units.txt")
    with open(units, "w") as f:
        f.writelines(f"u{i:04d}\n" for i in range(CORPUS["UNITS"]))
    for split in splits:
        with open(os.path.join(data, f"{split}.json")) as f:
            manifest = json.load(f)
        kdir = os.path.join(root, split)
        os.makedirs(kdir)
        for name, key in (("wav.scp", "wave"), ("token_text", "token_text"), ("utt2num_frames", "utt2num_frames")):
            with open(os.path.join(kdir, name), "w") as f:
                f.writelines(f"{u} {e[key]}\n" for u, e in manifest.items())
        os.remove(os.path.join(data, f"{split}.json"))
    os.remove(os.path.join(data, "dict.txt"))
    secs = {"corpus": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for split in splits:
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
    return corpus, cmvn, secs


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
# the recipe's LM stage (run.sh:61-77, with swbd's run.sh:42-70 binarize):
# seeded sentences of 10-60 of the 5,000 units (LibriSpeech transcript
# lengths: a normal around 35, sd 12), units drawn from a Zipf law (rank^-1,
# ranks a seeded permutation of the units), binarized into 512-token blocks
# (tokens_per_sample's default), 16 blocks a batch: ~20 updates in one epoch
LM_CORPUS = dict(train=4500, valid=300, MEAN_U=35, SD_U=12, MIN_U=10, MAX_U=60, BATCH=16)
# the card against the CPU: two fp32 steps of two 64-token rows (TF32 off)
LM_CPU_ROWS, LM_CPU_TOKENS = 2, 64
LM_CPU_LOSS_RTOL, LM_CPU_GNORM_RTOL = 1e-4, 1e-3
# eval_lm's nll against the train CLI's valid nll for the same checkpoint:
# the same tokens in other batches (other bf16 products)
LM_EVAL_RTOL = 0.005


def run_recipe_lm(dev, tmpdir: str, card: str) -> dict:
    """``recipe_lm`` with the CLIs' log lines on stderr beside this
    script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_lm(dev, tmpdir, card)


def write_lm_corpus(root: str, units: int, seed: int = 3) -> dict:
    """``lm_train.txt`` / ``lm_valid.txt`` (LM_CORPUS's sentences) and the
    unit inventory ``units.txt`` under ``root``; returns the sentences and
    tokens of each split."""
    import os

    rng = np.random.default_rng(seed)
    vocab = np.array([f"u{i:04d}" for i in range(units)])
    with open(os.path.join(root, "units.txt"), "w") as f:
        f.writelines(f"{u}\n" for u in vocab)
    p = 1.0 / np.arange(1, units + 1)
    p = (p / p.sum())[np.argsort(rng.permutation(units))]
    out = {}
    for split in ("train", "valid"):
        n = LM_CORPUS[split]
        lens = np.clip(np.rint(rng.normal(LM_CORPUS["MEAN_U"], LM_CORPUS["SD_U"], n)),
                       LM_CORPUS["MIN_U"], LM_CORPUS["MAX_U"]).astype(int)
        toks = vocab[rng.choice(units, size=int(lens.sum()), p=p)]
        with open(os.path.join(root, f"lm_{split}.txt"), "w") as f:
            for sent in np.split(toks, np.cumsum(lens)[:-1]):
                f.write(" ".join(sent) + "\n")
        out[split] = dict(sentences=n, tokens=int(lens.sum()))
    return out


def compare_lm_train_steps(dev, data: str, dict_path: str) -> dict:
    """Two fp32 train steps of the recipe's LM (full width, seeded weights)
    on the card and on the CPU, on LM_CPU_ROWS blocks of the binarized train
    split cut to LM_CPU_TOKENS: the loss within LM_CPU_LOSS_RTOL and the
    gradient norm within LM_CPU_GNORM_RTOL, relative, at each step."""
    import os

    from espresso_tpu_torch.config import EspressoConfig
    from espresso_tpu_torch.criterions import CrossEntropyV2
    from espresso_tpu_torch.data.dataset import BatchSpec
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.data.indexed_dataset import LMBlockDataset
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
    from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_train_step

    dic = AsrDictionary.load(dict_path)
    ds = LMBlockDataset(os.path.join(data, "lm_train"), dic)
    spec = BatchSpec(indices=np.arange(LM_CPU_ROWS), num_real=LM_CPU_ROWS, src_bucket=LM_CPU_TOKENS,
                     tgt_bucket=LM_CPU_TOKENS)
    batch = {k: torch.from_numpy(v[None]) for k, v in ds.collate(spec).items() if isinstance(v, np.ndarray)}
    cfg = EspressoConfig()
    cfg.common.dtype, cfg.criterion.name = "float32", "cross_entropy_v2"
    cfg.optimization.lr = [0.001]
    torch.manual_seed(0)
    ref = LSTMLanguageModel(LSTMLMConfig(vocab_size=len(dic), pad_index=dic.pad(), **LM_RECIPE))
    out = []
    for where in (dev, torch.device("cpu")):
        model = copy.deepcopy(ref).to(where)
        optimizer, _ = build_optimizer(cfg)
        state = create_train_state(model, optimizer, cfg)
        step = make_train_step(model, CrossEntropyV2(cfg.criterion, dic), optimizer, cfg)
        b = {k: v.to(where) for k, v in batch.items()}
        ms = [step(state, b, torch.Generator(device=where).manual_seed(0))[1] for _ in range(2)]
        out.append([(m["loss"].item(), m["gnorm"].item()) for m in ms])
    card, cpu = out
    rel = [(abs(c[0] - g[0]) / abs(c[0]), abs(c[1] - g[1]) / abs(c[1])) for c, g in zip(cpu, card)]
    res = dict(card=card, cpu=cpu, loss_rel_diff=max(r[0] for r in rel),
               gnorm_rel_diff=max(r[1] for r in rel), rows=LM_CPU_ROWS, tokens=LM_CPU_TOKENS)
    log(f"recipe LM two fp32 train steps, card vs CPU: {res} (bounds: loss {LM_CPU_LOSS_RTOL}, "
        f"gnorm {LM_CPU_GNORM_RTOL})")
    if not (res["loss_rel_diff"] <= LM_CPU_LOSS_RTOL and res["gnorm_rel_diff"] <= LM_CPU_GNORM_RTOL):
        raise AssertionError(f"the LM train step on the card disagrees with the CPU: {res}")
    return res


def recipe_lm(dev, tmpdir: str, card: str) -> dict:
    """The recipe's LM stage through the port's entry points at the full
    width of lstm_lm_librispeech (4 x 800, V = 5,003: the recipe's 5,000
    units with <pad>, </s>, <unk>), bf16 on fp32 masters, adam at lr 0.001
    as run.sh:68-74 trains it: ``prep text2vocabulary`` and ``prep
    binarize`` of a seeded corpus (LM_CORPUS), ``cli.train`` for one epoch
    with its valid pass, ``cli.eval_lm`` on the valid split; two fp32
    train steps on the card against the CPU. Asserts finite and falling
    losses and eval_lm's nll within LM_EVAL_RTOL of the CLI's valid nll.
    Returns the numbers and ``lm_dir``, the trained LM's directory."""
    import contextlib as cl
    import io
    import os

    from espresso_tpu_torch.cli import eval_lm, prep
    from espresso_tpu_torch.cli import train as train_cli

    root = os.path.join(tmpdir, "recipe_lm")
    data, lm_dir = os.path.join(root, "data"), os.path.join(root, "lm")
    os.makedirs(data)
    secs = {}
    t0 = time.perf_counter()
    corpus = write_lm_corpus(root, CORPUS["UNITS"])
    out = io.StringIO()
    with cl.redirect_stdout(out):
        prep.main(["text2vocabulary", "--vocabsize", str(CORPUS["UNITS"]), "--vocab",
                   os.path.join(root, "units.txt"), os.path.join(root, "lm_train.txt")])
    dict_path = os.path.join(data, "dict.txt")
    with open(dict_path, "w") as f:
        f.write(out.getvalue())
    for split in ("train", "valid"):
        prep.main(["binarize", "--text", os.path.join(root, f"lm_{split}.txt"), "--dict", dict_path,
                   "--output-prefix", os.path.join(data, f"lm_{split}")])
    secs["prep"] = time.perf_counter() - t0

    ev = lambda: torch.cuda.Event(enable_timing=True)
    rec = dict(events=[], losses=[], ntokens=[])
    make_step = train_cli.make_train_step

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen):
            e = [ev(), ev()]
            e[0].record()
            state, m = step(state, batch, gen)
            e[1].record()
            rec["events"].append(e)
            rec["losses"].append(m["loss"] / m["sample_size"])
            rec["ntokens"].append(m["ntokens"])
            return state, m
        return run

    args = [f"dataset.data={data}", "task.name=language_modeling_for_asr",
            "dataset.train_subset=lm_train", "dataset.valid_subset=lm_valid",
            "model.name=lstm_lm_librispeech", "criterion.name=cross_entropy_v2",
            "optimization.lr=0.001", "optimization.max_epoch=1",
            f"dataset.batch_size={LM_CORPUS['BATCH']}", f"checkpoint.save_dir={lm_dir}"]
    # the LM's training runs no kernel of the port (JAX trains it through
    # plain XLA): every count stays 0 through the train CLI and eval_lm
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused

    kernels = {**all_kernels(), **train_kernels(), "fbank": fbank_fused}
    for f in kernels.values():
        f.launches = 0
    train_cli.make_train_step = timed_step
    try:
        t0 = time.perf_counter()
        stats = train_cli.main(args, device=dev)
        torch.cuda.synchronize()
        secs["train"] = time.perf_counter() - t0
    finally:
        train_cli.make_train_step = make_step
    step_ms = [e[0].elapsed_time(e[1]) for e in rec["events"]]
    losses = torch.stack(rec["losses"]).tolist()
    ntokens = torch.stack(rec["ntokens"]).tolist()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"recipe LM train losses not finite and falling: {losses}")
    t0 = time.perf_counter()
    res = eval_lm.main([f"dataset.data={data}", "task.name=language_modeling_for_asr",
                        "dataset.gen_subset=lm_valid", f"checkpoint.save_dir={lm_dir}",
                        f"dataset.batch_size={LM_CORPUS['BATCH']}"], device=dev)
    secs["eval_lm"] = time.perf_counter() - t0
    launched = {name: f.launches for name, f in kernels.items() if f.launches}
    if launched:
        raise AssertionError(f"the LM stage launched kernels: {launched}")
    rel = abs(res["nll_loss"] - stats["valid_nll_loss"]) / stats["valid_nll_loss"]
    ckpt_dir = os.path.join(lm_dir, "checkpoint_last")
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f)) for f in os.listdir(ckpt_dir))
    t0 = time.perf_counter()
    cpu = compare_lm_train_steps(dev, data, dict_path)
    secs["card_vs_cpu"] = time.perf_counter() - t0
    n_steady = step_ms[1:] or step_ms
    out = dict(
        corpus=corpus, stage_s=secs, steps=len(step_ms), step_ms=step_ms,
        train_ms_per_step=statistics.mean(n_steady),
        tokens_per_s=sum(ntokens[1:] or ntokens) / (sum(n_steady) / 1e3),
        first_loss=losses[0], last_loss=losses[-1], losses=losses,
        valid_nll=stats["valid_nll_loss"], eval_lm=res, eval_lm_rel_diff=rel,
        checkpoint_bytes=ckpt_bytes, card_vs_cpu=cpu, lm_dir=lm_dir, card=card,
    )
    log(f"recipe LM stage on {card}: {len(step_ms)} steps, {out['train_ms_per_step']:.1f} ms a step after "
        f"the first ({step_ms[0]:.1f} ms), {out['tokens_per_s']:.0f} tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; eval_lm {res['ntokens']:.0f} tokens, nll {res['nll_loss']:.4f}, ppl "
        f"{res['ppl']:.2f} (the CLI's valid nll {stats['valid_nll_loss']:.4f}, {rel:.2e} apart); "
        f"checkpoint {ckpt_bytes} bytes; stages {secs}")
    if not rel <= LM_EVAL_RTOL:
        raise AssertionError(f"eval_lm nll {res['nll_loss']} vs the CLI's valid nll "
                             f"{stats['valid_nll_loss']}: {rel} > {LM_EVAL_RTOL}")
    return out


CLI_CORPUS = dict(train=32, valid=8)
CLI_EPOCHS = 2
CLI_SIGTERM_AFTER = 1
# the phase's depth, cut from the recipe's 16 conformer layers (the width
# stays the flagship's) so that the script stays near its time budget as
# later recipe phases join it
CLI_LAYERS = 8


def encoded_frames(T: int, enc_cfg) -> int:
    """The encoder's output length for T input frames: each conv layer of
    the frontend maps T to (T + (k - 1) // 2 + k // 2 - k) // stride + 1
    (``enc_cfg`` the encoder's config, or a model's that holds it as
    ``encoder``)."""
    enc_cfg = getattr(enc_cfg, "encoder", enc_cfg)
    for (kt, _), (st, _) in zip(enc_cfg.conv_kernel_sizes, enc_cfg.conv_strides):
        T = (T + (kt - 1) // 2 + kt // 2 - kt) // st + 1
    return T


# ROADMAP queue C item 3: one test WAV decoded alone at two paddings (206,960
# and 215,280 samples, the hub's batch and the test split's in an earlier
# run), and two runs of the train CLI for REPRO_STEPS updates from one seed
PADDINGS = (206960, 215280)
REPRO_STEPS = 3


def first_difference(a, b):
    """The first index where two token sequences differ (None if equal)."""
    a, b = [int(t) for t in a], [int(t) for t in b]
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None if a == b else min(len(a), len(b)))


def decode_at_paddings(dev, cfg, task, tree, wav: str) -> dict:
    """The WAV zero-padded to each of PADDINGS (or to its own length and
    8,320 past it, when longer), through the on-device front and the beam
    decoder of the recipe CLI's settings, in bf16 on the card and in fp32 on
    the CPU (the attention kernels take bf16 alone, and the card runs
    nothing else): per dtype the hypotheses and scores at each padding, the
    first token where they part, and the largest difference between the
    paddings of the valid frames' features and encoder outputs."""
    from espresso_tpu_torch.data.audio import read_wav
    from espresso_tpu_torch.train.trainer import make_device_feature_fn

    pcm, _ = read_wav(wav)
    S0 = len(pcm)
    pads = PADDINGS if S0 <= PADDINGS[0] else (S0, S0 + PADDINGS[1] - PADDINGS[0])
    prepare = make_device_feature_fn(cfg)
    feats = []
    for P in pads:
        w = torch.zeros(1, P, device=dev)
        w[0, :S0] = torch.from_numpy(pcm).to(dev)
        with torch.no_grad():
            feats.append(prepare({"src_waveforms": w, "num_samples": torch.tensor([S0], device=dev,
                                                                                    dtype=torch.int32)}))
    n = int(feats[0]["src_lengths"][0])
    out = dict(samples=S0, paddings=list(pads), frames=[int(f["src_frames"].shape[1]) for f in feats],
               feature_diff=(feats[0]["src_frames"][:, :n] - feats[1]["src_frames"][:, :n]).abs().max().item())
    for dtype, where in ((torch.float32, torch.device("cpu")), (torch.bfloat16, dev)):
        model = trained_model(task, tree, where).to(dtype).eval()
        dec = task.build_generator(model, cfg.generation)
        hyps, encs = [], []
        for f in feats:
            frames, lengths = f["src_frames"].to(where, dtype), f["src_lengths"].to(where)
            with torch.no_grad():
                enc = model.encode(frames, lengths)
            encs.append(enc.encoder_out[:, : int(enc.src_lengths[0])].float())
            hyps.append(dec.decode({"src_frames": frames, "src_lengths": lengths})[0][0])
        tag = "fp32" if dtype == torch.float32 else "bf16"
        out[tag] = dict(tokens=[[int(t) for t in h["tokens"]] for h in hyps], scores=[h["score"] for h in hyps],
                        part_at=first_difference(hyps[0]["tokens"], hyps[1]["tokens"]),
                        encoder_diff=(encs[0] - encs[1]).abs().max().item())
        del model, dec
    log(f"recipe CLI one WAV at two paddings (queue C item 3): {out}")
    return out


def train_reproducibility(dev, args, base_dir: str, tag: str = "recipe CLI") -> dict:
    """The recipe's train CLI twice from one seed for REPRO_STEPS updates
    (no checkpoint written, the valid pass skipped): each update's loss and
    gradient norm, and after
    each update the parameters; the first update where the runs differ and,
    at it, the loss's difference and the parameters that differ (by flax
    path, the largest first). Raises if the runs differ in any bit of any
    parameter after any update, or took other numbers of updates."""
    import os

    from espresso_tpu_torch.bridge import flax_paths
    from espresso_tpu_torch.cli import train as train_cli

    runs = []
    make_step, validate = train_cli.make_train_step, train_cli.validate
    for r in range(2):
        rec = []
        names = {}

        def recorded(model, *a, **kw):
            step = make_step(model, *a, **kw)
            names["params"] = [(name, p.numel()) for name, p in model.named_parameters()]
            names["paths"] = flax_paths(model)[0]

            def run(state, batch, gen, *rest):
                state, m = step(state, batch, gen, *rest)
                rec.append((m["loss"].item(), m["gnorm"].item(), state.params.detach().cpu().clone()))
                return state, m
            return run

        train_cli.make_train_step = recorded
        train_cli.validate = lambda *a, **kw: {"loss": 0.0}
        try:
            train_cli.main(args + [f"checkpoint.save_dir={os.path.join(base_dir, f'repro{r}')}",
                                   f"optimization.max_update={REPRO_STEPS}", "checkpoint.no_save=true"],
                           device=dev)
        finally:
            train_cli.make_train_step, train_cli.validate = make_step, validate
        runs.append(rec)
    a, b = runs
    out = dict(steps=[len(a), len(b)], losses=[[x[0] for x in a], [x[0] for x in b]],
               gnorms=[[x[1] for x in a], [x[1] for x in b]], first_differing_step=None)
    for k, (x, y) in enumerate(zip(a, b)):
        if x[0] == y[0] and x[1] == y[1] and torch.equal(x[2], y[2]):
            continue
        diffs, off = [], 0
        for name, size in names["params"]:
            d = (x[2][off : off + size] - y[2][off : off + size]).abs().max().item()
            if d > 0:
                diffs.append(("/".join(names["paths"][name]), d))
            off += size
        diffs.sort(key=lambda t: -t[1])
        out.update(first_differing_step=k + 1, loss_diff=x[0] - y[0], gnorm_diff=x[1] - y[1],
                   differing_params=len(diffs), of_params=len(names["params"]), largest=diffs[:12],
                   smallest=diffs[-6:])
        break
    log(f"{tag} train twice from one seed for {REPRO_STEPS} updates: {out}")
    if out["first_differing_step"] is not None or len(a) != len(b) or len(a) != REPRO_STEPS:
        raise AssertionError(f"{tag}: two train runs from one seed differ: {out}")
    return out


def run_recipe_clis(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """``recipe_clis`` with the CLIs' log lines (their handler writes to the
    stdout of the moment) on stderr beside this script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_clis(dev, tmpdir, card, lm_dir)


def recipe_clis(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """The recipe as run.sh runs it, through the port's entry points at the
    flagship width cut to CLI_LAYERS layers (d=512, V=5,004): stages 1-2
    (``prep asr_prep_json`` from wav.scp and token-text files, ``prep
    text2vocabulary`` over the 5,000 units, global CMVN from the train
    split); stage 4 (``cli.train.main`` on the card for CLI_EPOCHS epochs
    with WER validation, SIGTERM raised after CLI_SIGTERM_AFTER updates of
    epoch 2 and a second ``main`` resuming from checkpoint_last, with
    asynchronous checkpoint writes); stage 5 (``average_checkpoints
    --num-epoch-checkpoints 2``, then ``speech_recognize`` from
    checkpoint_avg at beam 10, beta 2, gamma 2.3, and again fused at
    lm_weight 0.47 with the LSTM LM that the "recipe LM stage" trained in
    ``lm_dir``, its vocab the dictionary's without the blank); the
    hub's ``transcribe`` on two WAVs against ``speech_recognize``'s
    hypotheses on the same inputs. Asserts
    every kernel's launches per train step, per valid batch and per decode
    batch, finite losses, the update count and iterator position after the
    resume, V = 5,004 and the four result files. Returns the recipe_cli
    numbers."""
    import json
    import logging
    import os
    import signal

    from espresso_tpu_torch import hub
    from espresso_tpu_torch.cli import average_checkpoints, speech_recognize
    from espresso_tpu_torch.cli import train as train_cli
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import decode_kernels
    from espresso_tpu_torch.train import checkpoint as ckpt

    root = os.path.join(tmpdir, "recipe_cli")
    data, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpts")
    os.makedirs(data)
    secs = {}
    corpus, cmvn, prep_secs = prep_recipe_data(root, data, dict(CLI_CORPUS))
    secs.update(prep_secs)
    recipe = copy.deepcopy(RECIPE)
    recipe["dataset"].update(data=data, global_cmvn_stats_path=cmvn)
    recipe["checkpoint"]["save_dir"] = save_dir
    recipe["optimization"]["max_epoch"] = CLI_EPOCHS
    recipe["model"]["encoder"] = {"encoder_layers": CLI_LAYERS}
    cfg_path = os.path.join(root, "recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    args = ["--config", cfg_path]
    from espresso_tpu_torch.config import load_config_dict, parse_config
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
    with open(os.path.join(lm_dir, "model_cfg.json")) as f:
        lm_cfg = json.load(f)["config"]
    if lm_cfg["vocab_size"] != V - 1 or lm_cfg["num_layers"] != LM_RECIPE["num_layers"] \
            or lm_cfg["hidden_size"] != LM_RECIPE["hidden_size"]:
        raise AssertionError(f"the trained LM's config {lm_cfg} against V = {V} and {LM_RECIPE}")
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

    # the hub on two of the test WAVs against speech_recognize on the same
    # inputs: a split of their wave paths alone, as transcribe writes it, with
    # the recipe's batching in both, so that both pad them alike (a bf16
    # decode's hypotheses may move with the padding: a near-tie of this
    # briefly trained model flipped a token between the test split's padding
    # and the hub's)
    t0 = time.perf_counter()
    with open(os.path.join(data, "test.json")) as f:
        test = json.load(f)
    utts = sorted(test)[:2]
    with open(os.path.join(data, "hub.json"), "w") as f:
        json.dump({f"hub_utt{i:06d}": {"wave": test[u]["wave"]} for i, u in enumerate(utts)}, f)
    hub_dir = os.path.join(root, "decode_hub")
    speech_recognize.main(dec_args + ["dataset.gen_subset=hub", f"generation.results_path={hub_dir}"],
                          device=dev)
    batching = {f"dataset.{k}": v for k, v in RECIPE["dataset"].items() if k != "specaugment_config"}
    asr = hub.from_pretrained(save_dir, data_dir=data, beam=10, device=dev, **batching, **{
        "checkpoint.restore_file": "checkpoint_avg", "dataset.global_cmvn_stats_path": cmvn,
        "generation.expansion_beta": 2, "generation.expansion_gamma": 2.3})
    got = asr.transcribe([test[u]["wave"] for u in utts])
    secs["hub"] = time.perf_counter() - t0
    cli = {}
    with open(os.path.join(hub_dir, "decoded_results.txt")) as f:
        for line in f:
            u, _, hyp = line.rstrip("\n").partition(" ")
            cli[u] = hyp
    want = [cli[f"hub_utt{i:06d}"] for i in range(len(utts))]
    if got != want:
        raise AssertionError(f"hub {got} != the CLI's {want}")
    log(f"recipe CLI hub: {utts} -> {got}, the CLI's hypotheses")
    del asr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dec_cfg = parse_config(dec_args)
    dec_task = setup_task(dec_cfg)
    avg_tree = ckpt.load_raw_checkpoint(os.path.join(save_dir, "checkpoint_avg"))
    paddings = decode_at_paddings(dev, dec_cfg, dec_task, avg_tree, test[utts[0]]["wave"])
    del avg_tree, dec_task
    torch.cuda.empty_cache()
    secs["paddings"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    repro = train_reproducibility(dev, args, root)
    secs["reproducibility"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return dict(
        corpus=corpus, vocab=V, layers=layers, stage_s=secs, steps=n, steps_by_epoch=rec["epoch_steps"],
        train_ms_per_step=statistics.mean(step_ms), step_ms=step_ms, valid_batches=nv,
        valid_ms_per_batch=sum(rec["valid_s"]) / nv * 1e3, valid_wer=rec.get("wer"), losses=losses,
        sigterm=sigterm_state, train_launches=train_counts,
        checkpoint_bytes=size("checkpoint_last"), device_to_host_s=rec["copies"],
        saves=[dict(name=a, async_write=b, s=c) for a, b, c in rec["saves"]], decodes=decodes,
        hub=dict(utts=utts, hyps=got), paddings=paddings, reproducibility=repro, card=card,
    )


# the attention encoder-decoder's recipe, examples/asr_librispeech/lstm_librispeech.yaml,
# written out (tests/test_torch_speech_lstm.py holds the two equal)
LSTM_RECIPE = {
    "task": {"name": "speech_recognition_espresso"},
    "criterion": {"name": "label_smoothed_cross_entropy_v2", "label_smoothing": 0.1,
                  "smoothing_type": "uniform"},
    "model": {"name": "speech_conv_lstm_librispeech"},
    "dataset": {"feat_dim": 80, "max_tokens": 26000, "num_batch_buckets": 10},
    "optimizer": {"name": "adam"},
    "lr_scheduler": {"name": "reduce_lr_on_plateau_v2", "lr_shrink": 0.5, "start_reduce_lr_epoch": 11},
    "optimization": {"lr": [0.001], "clip_norm": 2.0, "max_epoch": 30, "update_freq": [2]},
    "generation": {"beam": 60, "max_len_a": 0.08, "lm_weight": 0.47, "eos_factor": 1.5},
    "checkpoint": {"save_dir": "ckpts_lstm", "best_checkpoint_metric": "wer"},
}
# the phase's cuts of LSTM_RECIPE: a seeded WAV corpus (CORPUS's lengths and
# 5,000 units) of LSTM_CORPUS utterances through the on-device front (B10,
# global CMVN); frame batches of LSTM_MAX_TOKENS (the yaml's 26,000 would
# make one update an epoch here) so that each of 2 epochs takes ~5 updates
# of 2 microbatches; the epoch checkpoints off (checkpoint_best and
# checkpoint_last stay, ~2 GB each with adam's moments)
LSTM_CORPUS = dict(train=40, valid=8)
LSTM_MAX_TOKENS = 6000
# two fp32 train steps, card against CPU, on LSTM_CPU_ROWS utterances cut to
# LSTM_CPU_FRAMES frames and LSTM_CPU_TOKENS tokens (the CPU takes seconds
# a step at this width); a 2-utterance beam decode, card against CPU, fp32,
# beam 60 with the LM, cut to LSTM_SUB_MAX_LEN output steps, of a seeded
# model whose output layer is scaled by LSTM_SEEDED_PEAK (the briefly
# trained checkpoint gives the same one-token hypothesis for every input;
# these weights give hypotheses of many tokens that depend on the input)
LSTM_CPU_ROWS, LSTM_CPU_FRAMES, LSTM_CPU_TOKENS = 2, 160, 8
LSTM_SUB_MAX_LEN, LSTM_SEEDED_PEAK = 20, 6.0
# fp32 on both: cuDNN's LSTM and cuBLAS beside ATen's CPU loops sum in other
# orders; the loss to 1e-4 and the gradient norm to 1e-3, relative (as the
# LM stage holds its steps); each of the n-best's scores to 1e-4 relative
LSTM_CPU_LOSS_RTOL, LSTM_CPU_GNORM_RTOL, LSTM_BEAM_SCORE_RTOL = 1e-4, 1e-3, 1e-4
# cuDNN's copy of an encoder layer's weights into one buffer at each call:
# one layer's forward and backward at the recipe's layers 1-3 (D = 2 x 1024
# in, H = 1024), bf16, on a [LSTM_COMPACT_B, LSTM_COMPACT_T] batch of encoder
# frames, with the port's separate weights and with one flattened buffer
LSTM_COMPACT_B, LSTM_COMPACT_T = 8, 400


def run_recipe_lstm(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """``recipe_lstm`` with the CLIs' log lines on stderr beside this
    script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_lstm(dev, tmpdir, card, lm_dir)


def recipe_sub_batch(dev, cfg, rows: int):
    """(task, batch): the first ``rows`` utterances of the test split, as
    log-mel frames from the on-device front (B10, global CMVN) on the card
    cut to the longest of them, and their targets."""
    from espresso_tpu_torch.cli.train import put_batch
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train.trainer import make_device_feature_fn

    cfg = copy.deepcopy(cfg)
    cfg.dataset.num_batch_buckets = 1  # one batch of the whole split
    task = setup_task(cfg)
    ds = task.load_dataset("test")
    group = next(iter(task.get_batch_iterator(ds, None, len(ds), shuffle=False).next_epoch_itr()))
    mb = {k: v[0][:rows] for k, v in put_batch(group, dev).items()}
    with torch.no_grad():
        mb = make_device_feature_fn(cfg)(mb)
    mb["src_frames"] = mb["src_frames"][:, : int(mb["src_lengths"].max())]
    return task, mb


def trained_model(task, tree, where):
    """The task's model (the LSTM's or the transformer's) on ``where`` with
    the checkpoint tree's weights, its init drawn on ``where`` (the position
    tables, buffers no checkpoint holds, built as at any init)."""
    from espresso_tpu_torch.bridge import load_jax_variables
    from espresso_tpu_torch.registry import MODELS

    base, mcfg = task.build_model_config()
    with torch.device(where):
        model = MODELS.get(base)(mcfg).to(where)
    return load_jax_variables(model, {"params": tree["params"], "batch_stats": tree["batch_stats"]})


def compare_train_steps_card_cpu(dev, cfg, tree, tag: str = "LSTM") -> dict:
    """Two fp32 train steps of the recipe's model (full width, the trained
    checkpoint's weights, dropout 0, no SpecAugment) on the card and on the
    CPU, on LSTM_CPU_ROWS test utterances cut to LSTM_CPU_FRAMES frames and
    LSTM_CPU_TOKENS tokens: the loss within LSTM_CPU_LOSS_RTOL and the
    gradient norm within LSTM_CPU_GNORM_RTOL, relative, at each step."""
    from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_train_step

    cfg = copy.deepcopy(cfg)
    cfg.common.dtype = "float32"
    model_section(cfg)["dropout"] = 0.0
    # the card's and the CPU's generators draw other SpecAugment masks
    cfg.dataset.specaugment_config = None
    task, mb = recipe_sub_batch(dev, cfg, LSTM_CPU_ROWS)
    T, U = LSTM_CPU_FRAMES, LSTM_CPU_TOKENS
    batch = {"src_frames": mb["src_frames"][:, :T].float(), "src_lengths": mb["src_lengths"].clamp(max=T),
             "target": mb["target"][:, :U], "prev_output_tokens": mb["prev_output_tokens"][:, :U],
             "tgt_lengths": mb["tgt_lengths"].clamp(max=U), "weight": mb["weight"]}
    out = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        model = trained_model(task, tree, where)
        optimizer, _ = build_optimizer(cfg)
        state = create_train_state(model, optimizer, cfg)
        step = make_train_step(model, task.build_criterion(), optimizer, cfg)
        b = {k: v[None].to(where) for k, v in batch.items()}
        t1 = time.perf_counter()
        ms = [step(state, b, torch.Generator(device=where).manual_seed(0))[1] for _ in range(2)]
        out.append(([(m["loss"].item(), m["gnorm"].item()) for m in ms], t1 - t0, time.perf_counter() - t1))
        del model, state
    (card_steps, card_setup_s, card_s), (cpu_steps, cpu_setup_s, cpu_s) = out
    rel = [(abs(c[0] - g[0]) / abs(c[0]), abs(c[1] - g[1]) / abs(c[1])) for c, g in zip(cpu_steps, card_steps)]
    res = dict(card=card_steps, cpu=cpu_steps, loss_rel_diff=max(r[0] for r in rel),
               gnorm_rel_diff=max(r[1] for r in rel), rows=LSTM_CPU_ROWS, frames=T, tokens=U,
               card_s=card_s, cpu_s=cpu_s, card_setup_s=card_setup_s, cpu_setup_s=cpu_setup_s)
    log(f"recipe {tag} two fp32 train steps, card vs CPU: {res} (bounds: loss {LSTM_CPU_LOSS_RTOL}, "
        f"gnorm {LSTM_CPU_GNORM_RTOL})")
    if not (res["loss_rel_diff"] <= LSTM_CPU_LOSS_RTOL and res["gnorm_rel_diff"] <= LSTM_CPU_GNORM_RTOL):
        raise AssertionError(f"the {tag} train step on the card disagrees with the CPU: {res}")
    return res


def seeded_model(task, seed: int, peak: float = LSTM_SEEDED_PEAK):
    """The task's model on the CPU, fp32, from torch's seeded init at
    LeCun's scale (1/sqrt(fan-in)) with the output layer x ``peak``, so
    that the decoder's choices are not near-ties."""
    from espresso_tpu_torch.registry import MODELS

    base, mcfg = task.build_model_config()
    torch.manual_seed(seed)
    model = MODELS.get(base)(mcfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.ndim > 1 and "embed" not in name:
                p.mul_(3 ** 0.5 * (peak if "fc_out" in name else 1.0))
    return model.eval()


def model_section(cfg) -> dict:
    """The dict of the model's own options in ``cfg.model``: its
    ``encoder`` section for an encoder-only model (``model.encoder.*``),
    else the section itself."""
    return cfg.model["encoder"] if isinstance(cfg.model.get("encoder"), dict) else cfg.model


def compare_beam_card_cpu(dev, cfg, lm_dir: str, tag: str = "LSTM") -> dict:
    """A 2-utterance fp32 beam decode (beam 60, eos_factor 1.5, the LM at
    0.47, LSTM_SUB_MAX_LEN output steps) of the recipe's model from a seeded
    init (``seeded_model``) on the card and on the CPU, from the same frames:
    each utterance's n-best holds the same token sequences (two whose
    scores agree within LSTM_BEAM_SCORE_RTOL may swap ranks: a near-tie,
    which ``nbest_share_equal``, the share equal rank by rank, counts), every
    rank's score within LSTM_BEAM_SCORE_RTOL, relative, the top-1 equal and
    of more than one token."""
    from espresso_tpu_torch.cli.speech_recognize import _load_lm_checkpoint
    from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder

    cfg = copy.deepcopy(cfg)
    cfg.common.dtype = "float32"
    task, mb = recipe_sub_batch(dev, cfg, 2)
    gen = cfg.generation
    cpu_model = seeded_model(task, seed=17)
    out = []
    for where, model in ((dev, copy.deepcopy(cpu_model).to(dev)), (torch.device("cpu"), cpu_model)):
        lm = _load_lm_checkpoint(lm_dir, where, torch.float32)[0]
        dec = BeamSearchDecoder(model, task.dictionary, beam_size=gen.beam, max_len_a=0.0,
                                max_len_b=LSTM_SUB_MAX_LEN, eos_factor=gen.eos_factor, lm=lm,
                                lm_weight=gen.lm_weight)
        t0 = time.perf_counter()
        hyps = dec.decode({"src_frames": mb["src_frames"].float().to(where),
                           "src_lengths": mb["src_lengths"].to(where)})
        out.append((hyps, time.perf_counter() - t0))
        del model, lm
    del cpu_model
    (card, card_s), (cpu, cpu_s) = out
    seqs = lambda hyps: sorted(tuple(int(t) for t in h["tokens"]) for h in hyps)
    same = [sum(np.array_equal(g["tokens"], w["tokens"]) for g, w in zip(gb, wb)) / len(wb)
            for gb, wb in zip(card, cpu)]
    rel = [max(abs(g["score"] - w["score"]) / abs(w["score"]) for g, w in zip(gb, wb))
           for gb, wb in zip(card, cpu)]
    res = dict(nbest_sets_equal=[seqs(gb) == seqs(wb) for gb, wb in zip(card, cpu)],
               nbest_share_equal=same, nbest_score_rel_diff=max(rel),
               top1_equal=[bool(np.array_equal(gb[0]["tokens"], wb[0]["tokens"])) for gb, wb in zip(card, cpu)],
               top1_lengths=[len(gb[0]["tokens"]) for gb in card], distinct_top1=len({
                   tuple(gb[0]["tokens"]) for gb in card}),
               top1=[[int(t) for t in gb[0]["tokens"]] for gb in card], card_s=card_s, cpu_s=cpu_s)
    log(f"recipe {tag} 2-utterance fp32 beam_lm decode of a seeded model, card vs CPU: {res}")
    if not (all(res["nbest_sets_equal"]) and all(res["top1_equal"])
            and res["nbest_score_rel_diff"] <= LSTM_BEAM_SCORE_RTOL and min(res["top1_lengths"]) > 1):
        raise AssertionError(f"the {tag} beam decode on the card disagrees with the CPU: {res}")
    return res


def time_lstm_weight_compaction(dev, mcfg) -> dict:
    """One encoder layer's forward and backward (``LSTMLayer``, bf16, at
    the recipe's layers 1-3) with the port's separate weights, which cuDNN
    copies into one buffer at each call, and with ``nn.LSTM``'s flattened
    buffer holding the same weights: ms each (median of 10 after 3
    warm-up calls on CUDA events) and the outputs' largest difference."""
    from espresso_tpu_torch.modules.lstm import LSTMLayer

    H = mcfg.encoder_hidden_size
    D = 2 * H
    torch.manual_seed(3)
    layer = LSTMLayer(D, H).to(dev, torch.bfloat16).train()
    flat = torch.nn.LSTM(D, H, batch_first=True)
    with torch.no_grad():
        flat.weight_ih_l0.copy_(layer.ih.weight)
        flat.weight_hh_l0.copy_(layer.hh_kernel)
        flat.bias_ih_l0.copy_(layer.ih.bias)
        flat.bias_hh_l0.zero_()
    flat = flat.to(dev, torch.bfloat16)  # flattens its weights into one buffer
    x = torch.randn(LSTM_COMPACT_B, LSTM_COMPACT_T, D, device=dev, dtype=torch.bfloat16)
    lengths = torch.full((LSTM_COMPACT_B,), LSTM_COMPACT_T, device=dev)
    runs = {"separate": lambda: layer(x, lengths), "flattened": lambda: flat(x)[0]}
    ms, outs = {}, {}
    for name, fn in runs.items():
        def once():
            y = fn()
            y.float().sum().backward()
            return y
        for _ in range(3):
            outs[name] = once().detach()
        times = []
        for _ in range(10):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            once()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms[name] = statistics.median(times)
    err = float((outs["separate"].float() - outs["flattened"].float()).abs().max())
    res = dict(ms_separate=ms["separate"], ms_flattened=ms["flattened"], max_abs_diff=err,
               shape=dict(B=LSTM_COMPACT_B, T=LSTM_COMPACT_T, D=D, H=H),
               weight_bytes=2 * sum(p.numel() for p in layer.parameters()))
    del layer, flat, x
    return res


def recipe_lstm(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """The attention encoder-decoder's recipe (lstm_librispeech.yaml,
    ``LSTM_RECIPE``) through the port's entry points at the full width of
    speech_conv_lstm_librispeech (a 4-layer bi-LSTM encoder of 1024, a
    3-layer decoder of 1024, Bahdanau attention 512, output embedding
    3,072, dropout 0.4, V = 5,003), bf16 on fp32 masters: a seeded WAV
    corpus fed through the on-device front; ``cli.train.main`` for one
    epoch with its valid pass (loss, greedy WER) and checkpoints, then a
    second ``main`` resuming from checkpoint_last for epoch 2 with
    asynchronous writes; two fp32 train steps card against CPU;
    ``speech_recognize`` of the test split at beam 60, eos_factor 1.5,
    max_len_a 0.08, alone and fused at 0.47 with the LM the "recipe LM
    stage" trained in ``lm_dir`` (the LM's plain step, as JAX's beam search
    runs it); a 2-utterance fp32 decode of a seeded model card against CPU;
    one encoder layer timed with separate and flattened weights. Asserts B10's
    launches (one a microbatch, two a valid batch, one a decode batch),
    finite losses, the resume's update count and iterator, the result
    files; counts the host syncs of each decode batch's launch (encoder and
    beam loop) and fails on any. Returns the numbers."""
    import json
    import logging
    import os
    import warnings

    from espresso_tpu_torch.cli import speech_recognize
    from espresso_tpu_torch.cli import train as train_cli
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train import checkpoint as ckpt

    root = os.path.join(tmpdir, "recipe_lstm")
    data, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpts")
    os.makedirs(data)
    secs = {}
    t0 = time.perf_counter()
    corpus = write_corpus(data, dict(LSTM_CORPUS), seed=5)
    with open(os.path.join(data, "test.json"), "w") as f, open(os.path.join(data, "valid.json")) as g:
        f.write(g.read())  # the decode split: the valid utterances
    cmvn = write_global_cmvn(data)
    secs["corpus_and_cmvn"] = time.perf_counter() - t0
    recipe = copy.deepcopy(LSTM_RECIPE)
    recipe["dataset"].update(data=data, feature_type="device_fbank", global_cmvn_stats_path=cmvn,
                             max_tokens=LSTM_MAX_TOKENS)
    recipe["checkpoint"].update(save_dir=save_dir, save_interval=0)
    recipe["optimization"]["max_epoch"] = 1
    cfg_path = os.path.join(root, "recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    args = ["--config", cfg_path]
    cfg = load_config_dict(recipe)
    task = setup_task(cfg)
    V, mcfg = len(task.dictionary), task.build_model_config()[1]
    with open(os.path.join(lm_dir, "model_cfg.json")) as f:
        lm_cfg = json.load(f)["config"]
    if V != CORPUS["UNITS"] + 3 or lm_cfg["vocab_size"] != V:  # the units, <pad>, </s>, <unk>
        raise AssertionError(f"V = {V}, the LM's {lm_cfg['vocab_size']}")
    del task
    widths = {k: getattr(mcfg, k) for k in ("encoder_hidden_size", "encoder_layers", "decoder_hidden_size",
                                            "decoder_layers", "attention_dim", "decoder_out_embed_dim",
                                            "dropout")}
    log(f"recipe LSTM: corpus {corpus}; {secs}; V = {V}; {widths}")

    # train: epoch 1, then a second main resuming for epoch 2
    fbank_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    rec = dict(steps=0, micro=0, step_events=[], losses=[], valid_batches=0, valid_s=[], wer=[])
    make_step, make_valid, validate = train_cli.make_train_step, train_cli.make_valid_step, train_cli.validate

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen, *rest):
            e = [ev(), ev()]
            e[0].record()
            state, m = step(state, batch, gen, *rest)
            e[1].record()
            rec["steps"] += 1
            rec["micro"] += batch["prev_output_tokens"].shape[0]
            rec["step_events"].append(e)
            rec["losses"].append(m["loss"])
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
        rec["wer"].append(stats.get("wer"))
        return stats

    patches = [(train_cli, "make_train_step", counted_step), (train_cli, "make_valid_step", counted_valid),
               (train_cli, "validate", timed_validate)]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        t0 = time.perf_counter()
        train_cli.main(args, device=dev)
        secs["train_epoch1"] = time.perf_counter() - t0
        n1 = rec["steps"]
        t0 = time.perf_counter()
        stats = train_cli.main(args + ["optimization.max_epoch=2",
                                       "checkpoint.write_checkpoints_asynchronously=true"], device=dev)
        secs["train_epoch2_resumed"] = time.perf_counter() - t0
    finally:
        for mod, name, _ in patches:
            setattr(mod, name, {"make_train_step": make_step, "make_valid_step": make_valid,
                                "validate": validate}[name])
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    n, nv = rec["steps"], rec["valid_batches"]
    train_launches = fbank_fused.launches
    if train_launches != rec["micro"] + 2 * nv or n1 == 0 or n == n1:
        raise AssertionError(f"recipe LSTM train: B10 launched {train_launches} times for {rec['micro']} "
                             f"microbatches and {nv} valid batches; steps {n1} then {n}")
    losses = torch.stack(rec["losses"]).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recipe LSTM train losses {losses}")
    tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
    if int(tree["step"]) != n or host["iterator"]["epoch"] != 3 or host["iterator"]["iterations_in_epoch"]:
        raise AssertionError(f"after the resume: step {int(tree['step'])} of {n}, iterator {host['iterator']}")
    names = sorted(os.listdir(save_dir))
    if not {"checkpoint_best", "checkpoint_last", "model_cfg.json"} <= set(names):
        raise AssertionError(f"checkpoints {names}")
    step_ms = [e[0].elapsed_time(e[1]) for e in rec["step_events"]]
    n_params = sum(int(np.prod(v.shape)) for v in ckpt.flatten_tree(tree["params"]).values())
    log(f"recipe LSTM train on {card}: {n} steps ({n1} in epoch 1, then resumed), {rec['micro']} "
        f"microbatches, step ms {[round(x, 1) for x in step_ms]}, {nv} valid batches in {rec['valid_s']} s, "
        f"WER {rec['wer']}, peak memory {train_peak / 2**30:.2f} GiB, {n_params:,} params, losses "
        f"{[round(x, 3) for x in losses]}, B10 launches {train_launches}; {stats}")
    torch.cuda.empty_cache()

    cpu_steps = compare_train_steps_card_cpu(dev, cfg, tree)
    torch.cuda.empty_cache()

    # decode the test split at the yaml's beam, alone and with the LM
    calls = []
    run_async = BeamSearchDecoder.decode_async

    def counted_async(self, batch, *a, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = run_async(self, batch, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        calls.append((tuple(batch["src_frames"].shape), syncs))
        return handle

    class Elapsed(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Recognized"):
                rec["elapsed"] = record.args[1]

    handler = Elapsed()
    logging.getLogger("espresso_tpu_torch.recognize").addHandler(handler)
    decodes = {}
    audio_s = corpus["valid"]["audio_s"]
    try:
        BeamSearchDecoder.decode_async = counted_async
        for tag, extra in (("beam", ["generation.lm_weight=0.0"]), ("beam_lm", [f"generation.lm_path={lm_dir}"])):
            out_dir = os.path.join(root, f"decode_{tag}")
            fbank_fused.launches = 0
            calls.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = speech_recognize.main(args + extra + ["dataset.gen_subset=test",
                                                        f"generation.results_path={out_dir}"], device=dev)
            torch.cuda.synchronize()
            secs[f"decode_{tag}"] = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            syncs = sum(s for _, s in calls)
            if files != ["aligned_results.txt", "cer", "decoded_results.txt", "wer"] \
                    or res["num_utts"] != LSTM_CORPUS["valid"] or fbank_fused.launches != len(calls) or syncs:
                raise AssertionError(f"recipe LSTM {tag} decode: files {files}, result {res}, B10 "
                                     f"{fbank_fused.launches} for {len(calls)} batches, host syncs {calls}")
            decodes[tag] = dict(result=res, batches=[s for s, _ in calls], host_syncs=syncs,
                                fbank_launches=fbank_fused.launches, elapsed_s=rec["elapsed"],
                                rtfx=audio_s / rec["elapsed"], peak_bytes=torch.cuda.max_memory_allocated(),
                                wer_file=open(os.path.join(out_dir, "wer")).read().strip())
            log(f"recipe LSTM {tag} decode on {card}: {res}, batches {decodes[tag]['batches']} in "
                f"{rec['elapsed']:.3f} s, RTFx {audio_s / rec['elapsed']:.2f}, host syncs {syncs}, B10 "
                f"launches {fbank_fused.launches}, peak memory {decodes[tag]['peak_bytes'] / 2**30:.2f} GiB; "
                f"{decodes[tag]['wer_file']}")
    finally:
        BeamSearchDecoder.decode_async = run_async
        logging.getLogger("espresso_tpu_torch.recognize").removeHandler(handler)
    torch.cuda.empty_cache()
    del tree
    torch.cuda.empty_cache()
    sub = compare_beam_card_cpu(dev, cfg, lm_dir)
    torch.cuda.empty_cache()
    compaction = time_lstm_weight_compaction(dev, mcfg)
    log(f"recipe LSTM encoder layer fwd+bwd on {card}: {compaction}")
    torch.cuda.empty_cache()
    return dict(
        corpus=corpus, vocab=V, widths=widths, params=n_params, stage_s=secs, steps=n, steps_epoch1=n1,
        microbatches=rec["micro"], train_ms_per_step=statistics.mean(step_ms), step_ms=step_ms,
        valid_batches=nv, valid_s=rec["valid_s"], valid_wer=rec["wer"], losses=losses,
        train_peak_bytes=train_peak, fbank_launches=dict(train=train_launches, **{
            tag: d["fbank_launches"] for tag, d in decodes.items()}),
        decodes=decodes, card_vs_cpu_steps=cpu_steps, card_vs_cpu_beam=sub,
        encoder_layer_weight_compaction=compaction, card=card,
    )


# the transformer encoder-decoder's recipe, examples/asr_librispeech/
# transformer_librispeech.yaml, written out (tests/test_torch_speech_transformer.py
# holds the two equal)
TRANSFORMER_RECIPE = {
    "task": {"name": "speech_recognition_espresso"},
    "criterion": {"name": "label_smoothed_cross_entropy_v2", "label_smoothing": 0.1,
                  "smoothing_type": "uniform"},
    "model": {"name": "speech_transformer_librispeech", "encoder_pos_type": "relative"},
    "dataset": {"feat_dim": 80, "max_tokens": 22000, "num_batch_buckets": 10, "max_source_positions": 3600,
                "max_target_positions": 200,
                "specaugment_config": "{'time_warp_W': 0, 'freq_mask_F': 27, 'freq_mask_N': 2, "
                                      "'time_mask_pm': 0.04, 'time_mask_ps': 0.04}"},
    "optimizer": {"name": "adam"},
    "lr_scheduler": {"name": "tri_stage", "warmup_updates": 2750, "hold_steps": 101250, "decay_steps": 175000},
    "optimization": {"lr": [0.001], "clip_norm": 2.0, "max_epoch": 100, "update_freq": [8]},
    "generation": {"beam": 60, "max_len_a": 0.08, "lm_weight": 0.4, "eos_factor": 1.5},
    "checkpoint": {"save_dir": "ckpts_transformer", "best_checkpoint_metric": "wer"},
}
# the phase's cuts of TRANSFORMER_RECIPE: a seeded WAV corpus (CORPUS's
# lengths and 5,000 units) of TRANSFORMER_CORPUS utterances through the
# on-device front; frame batches of TRANSFORMER_MAX_TOKENS (the yaml's
# 22,000 with update_freq 8 would make one update of this corpus) so that
# each of 2 epochs takes ~2 updates of the yaml's 8 microbatches; the epoch
# checkpoints off (checkpoint_best and checkpoint_last stay)
TRANSFORMER_CORPUS = dict(train=56, valid=8)
TRANSFORMER_MAX_TOKENS = 3500
# the in-situ kernel checks: B1 over the encoder of TRANSFORMER_B1_ROWS test
# utterances, B2/B3 over one bf16 train step (the recipe's dropout) of
# TRANSFORMER_B23_ROWS
TRANSFORMER_B1_ROWS, TRANSFORMER_B23_ROWS = 4, 2


def run_recipe_transformer(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """``recipe_transformer`` with the CLIs' log lines on stderr beside this
    script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_transformer(dev, tmpdir, card, lm_dir)


def without_relative_leaves(tree):
    """The checkpoint tree without the relative attention's leaves
    (``pos_proj``, ``pos_bias_u``, ``pos_bias_v``): the weights of the same
    model with absolute positions."""
    drop = ("pos_proj", "pos_bias_u", "pos_bias_v")
    prune = lambda node: {k: prune(v) if isinstance(v, dict) else v for k, v in node.items() if k not in drop}
    return {"params": prune(tree["params"]), "batch_stats": tree["batch_stats"]}


def hold_attention_in_situ(dev, cfg, tree, layers: int, tag: str = "transformer") -> dict:
    """Every B1, B2 and B3 call of the recipe's model (the trained
    checkpoint's weights, bf16 compute) held against its plain version on
    its own inputs: the encoder in eval on TRANSFORMER_B1_ROWS test
    utterances (B1 a layer at the recipe's T'), and one train step at the
    recipe's dropout on TRANSFORMER_B23_ROWS (B2 and B3 a layer, their
    dropout replayed from the call's seed); bounds as the kernel checks'
    (2 bf16 ulps of the output, 8 of each gradient). Returns the max errors,
    the calls and T'."""
    from espresso_tpu_torch.modules import attention
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import train_kernel_checks as tc
    from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_train_step

    task, mb = recipe_sub_batch(dev, cfg, max(TRANSFORMER_B1_ROWS, TRANSFORMER_B23_ROWS))
    model = trained_model(task, tree, dev)
    errs = {"rel_attention": [], "rel_attention_train_fwd": [], "rel_attention_train_bwd": []}
    fwd, bwd = ak.rel_attention_train_fwd, ak.rel_attention_train_bwd

    def held_b1(*args):
        errs["rel_attention"].append(tc.check_rel_attention(*args))
        return ak.rel_attention(*args)

    def held_fwd(q_u, q_v, k, v, p, kv, seed, H, scale, rate):
        out = fwd(q_u, q_v, k, v, p, kv, seed, H, scale, rate)
        ref = ak.rel_attention_train_reference(q_u, q_v, k, v, p, kv, H, scale, rate, seed)
        errs["rel_attention_train_fwd"].append(tc._held("out", out, ref, tc.ATTN_OUT_ULPS, rate, {"q_u": q_u}))
        return out

    def held_bwd(q_u, q_v, k, v, p, kv, seed, g, H, scale, rate):
        grads = bwd(q_u, q_v, k, v, p, kv, seed, g, H, scale, rate)
        refs = ak.rel_attention_train_backward_reference(q_u, q_v, k, v, p, kv, g, H, scale, rate, seed)
        errs["rel_attention_train_bwd"].append(max(
            tc._held(n, x, r, tc.ATTN_GRAD_ULPS, rate, {"q_u": q_u})
            for n, x, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, refs)))
        return grads

    # the kernels count their launches on the module's name, the wrappers
    # here while they stand in it (launches for the comparison, not the path)
    held_fwd.launches = held_bwd.launches = 0
    rows = TRANSFORMER_B1_ROWS
    frames = mb["src_frames"][:rows, : int(mb["src_lengths"][:rows].max())]
    with swapped([(attention, "rel_attention", held_b1)]), torch.no_grad():
        enc = model.to(torch.bfloat16).eval().encode(frames.to(torch.bfloat16), mb["src_lengths"][:rows])
    T_enc = enc.encoder_out.shape[1]
    del model, enc
    model = trained_model(task, tree, dev)
    optimizer, _ = build_optimizer(cfg)
    state = create_train_state(model, optimizer, cfg)
    step = make_train_step(model, task.build_criterion(), optimizer, cfg)
    rows = TRANSFORMER_B23_ROWS
    T = int(mb["src_lengths"][:rows].max())
    batch = {"src_frames": mb["src_frames"][:rows, :T].float(), "src_lengths": mb["src_lengths"][:rows],
             "target": mb["target"][:rows], "prev_output_tokens": mb["prev_output_tokens"][:rows],
             "tgt_lengths": mb["tgt_lengths"][:rows], "weight": mb["weight"][:rows]}
    with swapped([(ak, "rel_attention_train_fwd", held_fwd), (ak, "rel_attention_train_bwd", held_bwd)]):
        _, m = step(state, {k: v[None] for k, v in batch.items()}, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    del model, state
    calls = {k: len(v) for k, v in errs.items()}
    if calls != {"rel_attention": layers, "rel_attention_train_fwd": layers, "rel_attention_train_bwd": layers} \
            or not math.isfinite(m["loss"].item()):
        raise AssertionError(f"in-situ attention calls {calls} for {layers} layers, loss {m['loss'].item()}")
    res = dict(max_abs_err={k: max(v) for k, v in errs.items()}, calls=calls, T_enc_b1=T_enc,
               T_enc_b23=encoded_frames(T, task.build_model_config()[1]))
    log(f"recipe {tag} in-situ B1/B2/B3 against their plain versions: {res}")
    return res


def recipe_transformer(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """The transformer encoder-decoder's recipe (transformer_librispeech.yaml,
    ``TRANSFORMER_RECIPE``) through the port's entry points at the full
    width of speech_transformer_librispeech (12 transformer encoder layers
    with relative positions and 6 decoder layers, d 512, ffn 2048, 8 heads,
    tied embedding, V = 5,003), bf16 on fp32 masters: a seeded WAV corpus
    fed through the on-device front; ``cli.train.main`` for one epoch with
    its valid pass (loss, greedy WER) and checkpoints, then a second
    ``main`` resuming from checkpoint_last for epoch 2 with asynchronous
    writes; two fp32 train steps card against CPU (with absolute positions:
    the relative attention's kernels take bf16 alone); ``speech_recognize`` of
    the test split at beam 60, eos_factor 1.5, max_len_a 0.08, alone and
    fused at 0.4 with the LM the "recipe LM stage" trained in ``lm_dir``; a
    2-utterance fp32 decode of a seeded model (its output layer untied)
    card against CPU; B1, B2 and
    B3 held against their plain versions in situ. Asserts the launches of
    B1 (a layer per valid-step and greedy-decode batch, a layer per decode
    batch), B2 and B3 (a layer per microbatch) and B10 (a microbatch, two a
    valid batch, one a decode batch), finite losses, the resume's update
    count and iterator, the result files; counts the host syncs of each
    decode batch's launch (encoder and beam loop) and fails on any. Returns
    the numbers."""
    import json
    import logging
    import os
    import warnings

    from espresso_tpu_torch.cli import speech_recognize
    from espresso_tpu_torch.cli import train as train_cli
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.decode.beam_search import BeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train import checkpoint as ckpt

    root = os.path.join(tmpdir, "recipe_transformer")
    data, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpts")
    os.makedirs(data)
    secs = {}
    t0 = time.perf_counter()
    corpus = write_corpus(data, dict(TRANSFORMER_CORPUS), seed=7)
    with open(os.path.join(data, "test.json"), "w") as f, open(os.path.join(data, "valid.json")) as g:
        f.write(g.read())  # the decode split: the valid utterances
    cmvn = write_global_cmvn(data)
    secs["corpus_and_cmvn"] = time.perf_counter() - t0
    recipe = copy.deepcopy(TRANSFORMER_RECIPE)
    recipe["dataset"].update(data=data, feature_type="device_fbank", global_cmvn_stats_path=cmvn,
                             max_tokens=TRANSFORMER_MAX_TOKENS)
    recipe["checkpoint"].update(save_dir=save_dir, save_interval=0)
    recipe["optimization"]["max_epoch"] = 1
    cfg_path = os.path.join(root, "recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    args = ["--config", cfg_path]
    cfg = load_config_dict(recipe)
    task = setup_task(cfg)
    V, mcfg = len(task.dictionary), task.build_model_config()[1]
    layers = mcfg.encoder_layers
    with open(os.path.join(lm_dir, "model_cfg.json")) as f:
        lm_cfg = json.load(f)["config"]
    if V != CORPUS["UNITS"] + 3 or lm_cfg["vocab_size"] != V:  # the units, <pad>, </s>, <unk>
        raise AssertionError(f"V = {V}, the LM's {lm_cfg['vocab_size']}")
    del task
    widths = {k: getattr(mcfg, k) for k in (
        "encoder_layer_type", "encoder_pos_type", "encoder_embed_dim", "encoder_ffn_dim", "encoder_layers",
        "encoder_heads", "decoder_embed_dim", "decoder_layers", "share_decoder_input_output_embed", "dropout")}
    log(f"recipe transformer: corpus {corpus}; {secs}; V = {V}; {widths}")

    # train: epoch 1, then a second main resuming for epoch 2
    kernels = {"fbank": fbank_fused, "rel_attention": ak.rel_attention,
               "rel_attention_train_fwd": ak.rel_attention_train_fwd,
               "rel_attention_train_bwd": ak.rel_attention_train_bwd}
    for f in kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    rec = dict(steps=0, micro=0, step_events=[], losses=[], valid_batches=0, valid_s=[], wer=[])
    make_step, make_valid, validate = train_cli.make_train_step, train_cli.make_valid_step, train_cli.validate

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen, *rest):
            e = [ev(), ev()]
            e[0].record()
            state, m = step(state, batch, gen, *rest)
            e[1].record()
            rec["steps"] += 1
            rec["micro"] += batch["prev_output_tokens"].shape[0]
            rec["step_events"].append(e)
            rec["losses"].append(m["loss"])
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
        rec["wer"].append(stats.get("wer"))
        return stats

    patches = [(train_cli, "make_train_step", counted_step), (train_cli, "make_valid_step", counted_valid),
               (train_cli, "validate", timed_validate)]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        t0 = time.perf_counter()
        train_cli.main(args, device=dev)
        secs["train_epoch1"] = time.perf_counter() - t0
        n1 = rec["steps"]
        t0 = time.perf_counter()
        stats = train_cli.main(args + ["optimization.max_epoch=2",
                                       "checkpoint.write_checkpoints_asynchronously=true"], device=dev)
        secs["train_epoch2_resumed"] = time.perf_counter() - t0
    finally:
        for mod, name, _ in patches:
            setattr(mod, name, {"make_train_step": make_step, "make_valid_step": make_valid,
                                "validate": validate}[name])
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    n, nv, micro = rec["steps"], rec["valid_batches"], rec["micro"]
    train_launches = {name: f.launches for name, f in kernels.items()}
    # a microbatch: B10, B2 and B3 a layer; a valid batch: the valid step
    # and the greedy WER decode, each B10 and B1 a layer
    want = {"fbank": micro + 2 * nv, "rel_attention": 2 * layers * nv,
            "rel_attention_train_fwd": layers * micro, "rel_attention_train_bwd": layers * micro}
    if train_launches != want or n1 == 0 or n == n1:
        raise AssertionError(f"recipe transformer train launches {train_launches}, want {want} ({micro} "
                             f"microbatches, {nv} valid batches); steps {n1} then {n}")
    losses = torch.stack(rec["losses"]).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recipe transformer train losses {losses}")
    tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
    if int(tree["step"]) != n or host["iterator"]["epoch"] != 3 or host["iterator"]["iterations_in_epoch"]:
        raise AssertionError(f"after the resume: step {int(tree['step'])} of {n}, iterator {host['iterator']}")
    names = sorted(os.listdir(save_dir))
    if not {"checkpoint_best", "checkpoint_last", "model_cfg.json"} <= set(names):
        raise AssertionError(f"checkpoints {names}")
    step_ms = [e[0].elapsed_time(e[1]) for e in rec["step_events"]]
    n_params = sum(int(np.prod(v.shape)) for v in ckpt.flatten_tree(tree["params"]).values())
    log(f"recipe transformer train on {card}: {n} steps ({n1} in epoch 1, then resumed), {micro} "
        f"microbatches, step ms {[round(x, 1) for x in step_ms]}, {nv} valid batches in {rec['valid_s']} s, "
        f"WER {rec['wer']}, peak memory {train_peak / 2**30:.2f} GiB, {n_params:,} params, losses "
        f"{[round(x, 3) for x in losses]}, launches {train_launches}; {stats}")
    torch.cuda.empty_cache()

    # the fp32 comparisons run the model with absolute positions (JAX's
    # default; the trained weights without the relative leaves): the
    # relative attention's kernels take bf16 alone, and on the card nothing
    # else runs it (they are held in situ below)
    abs_cfg = copy.deepcopy(cfg)
    abs_cfg.model["encoder_pos_type"] = "abs"
    cpu_steps = compare_train_steps_card_cpu(dev, abs_cfg, without_relative_leaves(tree), "transformer")
    torch.cuda.empty_cache()
    in_situ = hold_attention_in_situ(dev, cfg, tree, layers)
    torch.cuda.empty_cache()

    # decode the test split at the yaml's beam, alone and with the LM
    calls = []
    run_async = BeamSearchDecoder.decode_async

    def counted_async(self, batch, *a, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = run_async(self, batch, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        calls.append((tuple(batch["src_frames"].shape), syncs))
        return handle

    class Elapsed(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Recognized"):
                rec["elapsed"] = record.args[1]

    handler = Elapsed()
    logging.getLogger("espresso_tpu_torch.recognize").addHandler(handler)
    decodes = {}
    audio_s = corpus["valid"]["audio_s"]
    try:
        BeamSearchDecoder.decode_async = counted_async
        for tag, extra in (("beam", ["generation.lm_weight=0.0"]), ("beam_lm", [f"generation.lm_path={lm_dir}"])):
            out_dir = os.path.join(root, f"decode_{tag}")
            for f in kernels.values():
                f.launches = 0
            calls.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = speech_recognize.main(args + extra + ["dataset.gen_subset=test",
                                                        f"generation.results_path={out_dir}"], device=dev)
            torch.cuda.synchronize()
            secs[f"decode_{tag}"] = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            syncs = sum(s for _, s in calls)
            counts = {name: f.launches for name, f in kernels.items()}
            want = {"fbank": len(calls), "rel_attention": layers * len(calls), "rel_attention_train_fwd": 0,
                    "rel_attention_train_bwd": 0}
            if files != ["aligned_results.txt", "cer", "decoded_results.txt", "wer"] \
                    or res["num_utts"] != TRANSFORMER_CORPUS["valid"] or counts != want or syncs:
                raise AssertionError(f"recipe transformer {tag} decode: files {files}, result {res}, launches "
                                     f"{counts} (want {want}), host syncs {calls}")
            decodes[tag] = dict(result=res, batches=[s for s, _ in calls], host_syncs=syncs, launches=counts,
                                elapsed_s=rec["elapsed"], rtfx=audio_s / rec["elapsed"],
                                peak_bytes=torch.cuda.max_memory_allocated(),
                                wer_file=open(os.path.join(out_dir, "wer")).read().strip())
            log(f"recipe transformer {tag} decode on {card}: {res}, batches {decodes[tag]['batches']} in "
                f"{rec['elapsed']:.3f} s, RTFx {audio_s / rec['elapsed']:.2f}, host syncs {syncs}, launches "
                f"{counts}, peak memory {decodes[tag]['peak_bytes'] / 2**30:.2f} GiB; {decodes[tag]['wer_file']}")
    finally:
        BeamSearchDecoder.decode_async = run_async
        logging.getLogger("espresso_tpu_torch.recognize").removeHandler(handler)
    del tree
    torch.cuda.empty_cache()
    # the seeded model's output layer untied (fc_out, x LSTM_SEEDED_PEAK): a
    # random tied one scores the step's input token highest and ends its
    # hypotheses on eos after a token or two
    untied = copy.deepcopy(abs_cfg)
    untied.model["share_decoder_input_output_embed"] = False
    sub = compare_beam_card_cpu(dev, untied, lm_dir, "transformer")
    torch.cuda.empty_cache()
    return dict(
        corpus=corpus, vocab=V, widths=widths, params=n_params, stage_s=secs, steps=n, steps_epoch1=n1,
        microbatches=micro, train_ms_per_step=statistics.mean(step_ms), step_ms=step_ms,
        valid_batches=nv, valid_s=rec["valid_s"], valid_wer=rec["wer"], losses=losses,
        train_peak_bytes=train_peak, launches=dict(train=train_launches, **{
            tag: d["launches"] for tag, d in decodes.items()}),
        decodes=decodes, card_vs_cpu_steps=cpu_steps, card_vs_cpu_beam=sub, in_situ=in_situ, card=card,
    )


# the Transformer-CTC recipe, examples/asr_librispeech/
# transformer_ctc_librispeech.yaml, written out (tests/test_torch_ctc.py
# holds the two equal)
CTC_RECIPE = {
    "task": {"name": "speech_recognition_espresso"},
    "criterion": {"name": "ctc_loss"},
    "model": {"name": "transformer_ctc_librispeech", "encoder": {"encoder_pos_type": "relative"}},
    "dataset": {"feat_dim": 80, "max_tokens": 22000, "num_batch_buckets": 10, "max_source_positions": 3600,
                "max_target_positions": 200,
                "specaugment_config": "{'time_warp_W': 0, 'freq_mask_F': 27, 'freq_mask_N': 2, "
                                      "'time_mask_pm': 0.04, 'time_mask_ps': 0.04}"},
    "optimizer": {"name": "adam"},
    "lr_scheduler": {"name": "tri_stage", "warmup_updates": 2750, "hold_steps": 101250, "decay_steps": 175000},
    "optimization": {"lr": [0.001], "clip_norm": 2.0, "max_epoch": 100, "update_freq": [8]},
    "generation": {"beam": 10},
    "checkpoint": {"save_dir": "ckpts_transformer_ctc", "best_checkpoint_metric": "wer"},
}
# the phase's cuts of CTC_RECIPE: the transformer phase's seeded WAV corpus
# (TRANSFORMER_CORPUS, seed 7) through the on-device front; frame batches of
# TRANSFORMER_MAX_TOKENS and update_freq CTC_UPDATE_FREQ (the yaml's 8 would
# make ~5 updates an epoch of this corpus), so that one epoch takes at least
# CTC_MIN_UPDATES updates (11 of 4 microbatches); SIGTERM after
# CTC_SIGTERM_AFTER updates and a resume to the epoch's end and its valid
# pass; the epoch checkpoints off (checkpoint_best and checkpoint_last stay)
CTC_UPDATE_FREQ, CTC_MIN_UPDATES, CTC_SIGTERM_AFTER = 4, 10, 6
# the decodes run the recipe's model from a seeded init with its output
# layer x CTC_SEEDED_PEAK ("checkpoint_seeded", beside the trained
# checkpoints): the prefix search's host cost grows with the tokens of a
# frame that pass its 1e-5 pruning, all 5,004 for a random model (50,040
# extensions a frame at beam 10), ~8 at this peak; the model 11 updates
# old, peaked as far, emits blank at every frame (empty hypotheses, on an
# H100)
CTC_SEEDED_PEAK = 20.0
# where a microbatch's time goes: the criterion's forward and backward and
# the loss's alone, on the test split's first CTC_TIMED_ROWS utterances
CTC_TIMED_ROWS = 3
# the card-against-CPU prefix beam: each rank's tokens equal, each score
# within 1e-4 relative (the log-probs' sums of ~100 frames in f32, the
# encoder's sums in other orders)
CTC_BEAM_SCORE_RTOL = 1e-4


def run_recipe_transformer_ctc(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """``recipe_transformer_ctc`` with the CLIs' log lines on stderr beside
    this script's log."""
    with contextlib.redirect_stdout(sys.stderr):
        return recipe_transformer_ctc(dev, tmpdir, card, lm_dir)


def seeded_checkpoint(task, path: str, seed: int, peak: float) -> None:
    """The weights of ``seeded_model(task, seed, peak)`` as the checkpoint
    ``path`` (params and batch statistics)."""
    from espresso_tpu_torch.train import checkpoint as ckpt

    ckpt.save_checkpoint_state(path, ckpt.flatten_tree(ckpt.flax_variables(seeded_model(task, seed, peak))), {})


def time_ctc_loss(dev, cfg, tree) -> dict:
    """Where a CTC microbatch's time goes, on the test split's first
    CTC_TIMED_ROWS utterances through the trained model (bf16, train mode):
    the criterion's forward and backward, and ``ctc_loss``'s forward and
    backward alone on the same logits, each by CUDA events (the mean of 3
    after a warm-up), and the device operations one loss forward and
    backward launches (``torch.profiler``: kernels, copies and fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from espresso_tpu_torch.ops.ctc import ctc_loss

    task, mb = recipe_sub_batch(dev, cfg, CTC_TIMED_ROWS)
    model = trained_model(task, tree, dev).to(torch.bfloat16).train()
    crit = task.build_criterion()
    batch = {k: mb[k] for k in ("src_lengths", "target", "tgt_lengths", "weight")}
    batch["src_frames"] = mb["src_frames"].to(torch.bfloat16)
    with torch.no_grad():
        logits, enc = model(batch["src_frames"], batch["src_lengths"])
    blank = task.dictionary.blank()

    def microbatch():
        model.zero_grad(set_to_none=True)
        crit(model, batch)[0].backward()

    def loss_alone():
        x = logits.detach().requires_grad_()
        ctc_loss(x, enc.src_lengths, batch["target"], batch["tgt_lengths"], blank=blank).sum().backward()

    def events_ms(fn, n: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        for _ in range(n):
            fn()
        e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]) / n

    micro_ms, loss_ms = events_ms(microbatch), events_ms(loss_alone)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_alone()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    res = dict(rows=CTC_TIMED_ROWS, T_enc=int(logits.shape[1]), U_max=int(batch["tgt_lengths"].max()),
               microbatch_ms=micro_ms, ctc_loss_ms=loss_ms, ctc_loss_share=loss_ms / micro_ms,
               ctc_loss_device_ops=sum(e.count for e in ops),
               ctc_loss_device_ms=sum(e.self_device_time_total for e in ops) / 1e3)
    log(f"recipe transformer CTC a microbatch, criterion forward and backward against the loss's alone: {res}")
    del model
    return res


def compare_ctc_beam_card_cpu(dev, cfg, beam: int) -> dict:
    """A 2-utterance fp32 prefix beam decode (``beam``) of the recipe's
    model from a seeded init (``seeded_model`` at CTC_SEEDED_PEAK, absolute
    positions) on the card and on the CPU, from the same frames: each
    utterance's n-best equal rank by rank in its tokens, every score within
    CTC_BEAM_SCORE_RTOL, relative, the top-1 of more than one token; and the
    tokens a frame that pass the search's pruning."""
    from espresso_tpu_torch.decode.ctc_decoder import CTCPrefixBeamSearchDecoder

    cfg = copy.deepcopy(cfg)
    cfg.common.dtype = "float32"
    task, mb = recipe_sub_batch(dev, cfg, 2)
    cpu_model = seeded_model(task, seed=19, peak=CTC_SEEDED_PEAK)
    batch = {"src_frames": mb["src_frames"].float(), "src_lengths": mb["src_lengths"]}
    out = []
    for where, model in ((dev, copy.deepcopy(cpu_model).to(dev)), (torch.device("cpu"), cpu_model)):
        dec = CTCPrefixBeamSearchDecoder(model, task.dictionary, beam_size=beam)
        t0 = time.perf_counter()
        handle = dec.decode_async({k: v.to(where) for k, v in batch.items()})
        lp = handle[0].cpu()
        hyps = dec.collect(handle)
        out.append((hyps, time.perf_counter() - t0, lp))
        del model
    (card, card_s, lp), (cpu, cpu_s, _) = out
    passing = (lp >= math.log(1e-5)).sum(-1).float()
    rel = max(abs(g["score"] - w["score"]) / abs(w["score"]) for gb, wb in zip(card, cpu) for g, w in zip(gb, wb))
    res = dict(nbest_equal=[[list(map(int, h["tokens"])) for h in gb] == [list(map(int, h["tokens"])) for h in wb]
                            for gb, wb in zip(card, cpu)],
               nbest_sizes=[len(gb) for gb in card], nbest_score_rel_diff=rel,
               top1_lengths=[len(gb[0]["tokens"]) for gb in card],
               tokens_passing_pruning_a_frame=passing[passing > 0].mean().item(), card_s=card_s, cpu_s=cpu_s)
    log(f"recipe transformer CTC 2-utterance fp32 prefix beam ({beam}) of a seeded model, card vs CPU: {res}")
    if not (all(res["nbest_equal"]) and rel <= CTC_BEAM_SCORE_RTOL and min(res["top1_lengths"]) > 1):
        raise AssertionError(f"the CTC prefix beam on the card disagrees with the CPU: {res}")
    return res


def recipe_transformer_ctc(dev, tmpdir: str, card: str, lm_dir: str) -> dict:
    """The Transformer-CTC recipe (transformer_ctc_librispeech.yaml,
    ``CTC_RECIPE``) through the port's entry points at the full width of
    transformer_ctc_librispeech (12 transformer encoder layers with
    relative positions, d 512, ffn 2048, 8 heads, ``fc_out`` to V = 5,004),
    bf16 on fp32 masters: the transformer phase's seeded WAV corpus through
    ``prep`` (``prep_recipe_data``) and the on-device front;
    ``cli.train.main`` with its valid pass (loss, greedy
    WER) and checkpoints for one epoch, SIGTERM after CTC_SIGTERM_AFTER
    updates, then a second ``main`` resuming from checkpoint_last to the
    epoch's end with asynchronous writes; ``average_checkpoints`` of the
    SIGTERM checkpoint and the last, decoded greedily (beam 1) through
    ``speech_recognize``; two train runs from one seed bit for
    bit (``train_reproducibility``); two fp32 train steps card against CPU
    (absolute positions: the relative attention's kernels take bf16
    alone); B1, B2 and B3 held against their plain versions in situ;
    ``speech_recognize`` of the test split with the prefix beam at the
    yaml's beam 10, alone and with the LM the "recipe LM stage" trained in
    ``lm_dir`` (which the search takes and never reads, as JAX's: the same
    hypotheses), on seeded weights with the output layer peaked
    (``seeded_checkpoint``); a microbatch's time against the loss's
    (``time_ctc_loss``); the hub's ``transcribe`` on two WAVs against
    ``speech_recognize``'s hypotheses; a seeded fp32 prefix beam card
    against CPU. Asserts the launches of B10 (a microbatch, two a valid
    batch, one a decode batch), B1 (a layer per valid-step and
    greedy-decode batch and per decode batch), B2 and B3 (a layer a
    microbatch), finite losses, the update counts and iterator positions,
    the result files; counts the host syncs of each decode batch's launch
    and fails on any. Returns the numbers."""
    import json
    import logging
    import os
    import shutil
    import signal
    import warnings

    from espresso_tpu_torch import hub
    from espresso_tpu_torch.cli import average_checkpoints, speech_recognize
    from espresso_tpu_torch.cli import train as train_cli
    from espresso_tpu_torch.config import load_config_dict
    from espresso_tpu_torch.decode.ctc_decoder import CTCPrefixBeamSearchDecoder
    from espresso_tpu_torch.features.fbank_kernels import fbank_fused
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train import checkpoint as ckpt

    root = os.path.join(tmpdir, "recipe_transformer_ctc")
    data, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpts")
    os.makedirs(data)
    corpus, cmvn, secs = prep_recipe_data(root, data, dict(TRANSFORMER_CORPUS), seed=7)
    recipe = copy.deepcopy(CTC_RECIPE)
    recipe["dataset"].update(data=data, feature_type="device_fbank", global_cmvn_stats_path=cmvn,
                             max_tokens=TRANSFORMER_MAX_TOKENS)
    recipe["checkpoint"].update(save_dir=save_dir, save_interval=0)
    recipe["optimization"].update(max_epoch=1, update_freq=[CTC_UPDATE_FREQ])
    cfg_path = os.path.join(root, "recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    args = ["--config", cfg_path]
    cfg = load_config_dict(recipe)
    task = setup_task(cfg)
    V, mcfg = len(task.dictionary), task.build_model_config()[1]
    layers = mcfg.encoder.encoder_layers
    if V != CORPUS["UNITS"] + 4:  # the units, <pad>, </s>, <unk> and the blank (bos)
        raise AssertionError(f"V = {V}")
    del task
    widths = {k: getattr(mcfg.encoder, k) for k in (
        "encoder_layer_type", "encoder_pos_type", "encoder_embed_dim", "encoder_ffn_dim", "encoder_layers",
        "encoder_heads", "dropout")}
    log(f"recipe transformer CTC: corpus {corpus}; {secs}; V = {V}; {widths}")

    # train: SIGTERM in epoch 1, then a second main resuming
    kernels = {"fbank": fbank_fused, "rel_attention": ak.rel_attention,
               "rel_attention_train_fwd": ak.rel_attention_train_fwd,
               "rel_attention_train_bwd": ak.rel_attention_train_bwd}
    for f in kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    rec = dict(steps=0, micro=0, step_events=[], losses=[], valid_batches=0, valid_s=[], wer=[])
    make_step, make_valid, validate = train_cli.make_train_step, train_cli.make_valid_step, train_cli.validate

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, gen, *rest):
            e = [ev(), ev()]
            e[0].record()
            state, m = step(state, batch, gen, *rest)
            e[1].record()
            rec["steps"] += 1
            rec["micro"] += batch["prev_output_tokens"].shape[0]
            rec["step_events"].append(e)
            rec["losses"].append(m["loss"])
            if rec["steps"] == CTC_SIGTERM_AFTER and not rec.get("sigterm"):
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
        rec["wer"].append(stats.get("wer"))
        return stats

    patches = [(train_cli, "make_train_step", counted_step), (train_cli, "make_valid_step", counted_valid),
               (train_cli, "validate", timed_validate)]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        t0 = time.perf_counter()
        train_cli.main(args, device=dev)
        secs["train_until_sigterm"] = time.perf_counter() - t0
        tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
        want_it = {"epoch": 1, "iterations_in_epoch": CTC_SIGTERM_AFTER}
        if not rec.get("sigterm") or rec["valid_s"] or int(tree["step"]) != CTC_SIGTERM_AFTER \
                or any(host["iterator"][k] != v for k, v in want_it.items()):
            raise AssertionError(f"SIGTERM checkpoint: step {int(tree['step'])}, iterator {host['iterator']}, "
                                 f"valid passes {rec['valid_s']}; want {CTC_SIGTERM_AFTER} and {want_it}")
        del tree
        shutil.copytree(os.path.join(save_dir, "checkpoint_last"), os.path.join(save_dir, "checkpoint_sigterm"))
        t0 = time.perf_counter()
        stats = train_cli.main(args + ["checkpoint.write_checkpoints_asynchronously=true"], device=dev)
        secs["train_resumed"] = time.perf_counter() - t0
    finally:
        for mod, name, _ in patches:
            setattr(mod, name, {"make_train_step": make_step, "make_valid_step": make_valid,
                                "validate": validate}[name])
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    n, nv, micro = rec["steps"], rec["valid_batches"], rec["micro"]
    train_launches = {name: f.launches for name, f in kernels.items()}
    # a microbatch: B10, B2 and B3 a layer; a valid batch: the valid step
    # and the greedy WER decode, each B10 and B1 a layer
    want = {"fbank": micro + 2 * nv, "rel_attention": 2 * layers * nv,
            "rel_attention_train_fwd": layers * micro, "rel_attention_train_bwd": layers * micro}
    if train_launches != want or n < CTC_MIN_UPDATES or not rec["valid_s"]:
        raise AssertionError(f"recipe transformer CTC train launches {train_launches}, want {want} ({micro} "
                             f"microbatches, {nv} valid batches); {n} updates")
    losses = torch.stack(rec["losses"]).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recipe transformer CTC train losses {losses}")
    tree, host = ckpt.load_checkpoint_state(os.path.join(save_dir, "checkpoint_last"))
    if int(tree["step"]) != n or host["iterator"]["epoch"] != 2 or host["iterator"]["iterations_in_epoch"]:
        raise AssertionError(f"after the resume: step {int(tree['step'])} of {n}, iterator {host['iterator']}")
    names = sorted(os.listdir(save_dir))
    if not {"checkpoint_best", "checkpoint_last", "model_cfg.json"} <= set(names):
        raise AssertionError(f"checkpoints {names}")
    step_ms = [e[0].elapsed_time(e[1]) for e in rec["step_events"]]
    n_params = sum(int(np.prod(v.shape)) for v in ckpt.flatten_tree(tree["params"]).values())
    # the average of the SIGTERM checkpoint and the last, decoded greedily
    # (the generator at beam 1) through speech_recognize
    t0 = time.perf_counter()
    pair = [os.path.join(save_dir, f"checkpoint_{n}") for n in ("sigterm", "last")]
    average_checkpoints.main(["--inputs", *pair, "--output", os.path.join(save_dir, "checkpoint_avg")])
    trees = [ckpt.flatten_tree(ckpt.load_raw_checkpoint(p)["params"]) for p in pair + [
        os.path.join(save_dir, "checkpoint_avg")]]
    if any(not np.array_equal(((trees[0][k].astype(np.float64) + trees[1][k]) / 2).astype(np.float32),
                              trees[2][k]) for k in trees[2]):
        raise AssertionError("checkpoint_avg is not the mean of its two inputs")
    del trees
    greedy_dir = os.path.join(root, "decode_greedy")
    greedy = speech_recognize.main(args + ["checkpoint.restore_file=checkpoint_avg", "generation.beam=1",
                                           "dataset.gen_subset=test", f"generation.results_path={greedy_dir}"],
                                   device=dev)
    if sorted(os.listdir(greedy_dir)) != ["aligned_results.txt", "cer", "decoded_results.txt", "wer"] \
            or greedy["num_utts"] != TRANSFORMER_CORPUS["valid"]:
        raise AssertionError(f"recipe transformer CTC greedy decode of checkpoint_avg: {greedy}")
    secs["average_and_greedy_decode"] = time.perf_counter() - t0
    log(f"recipe transformer CTC train on {card}: {n} updates (SIGTERM after {CTC_SIGTERM_AFTER}, then "
        f"resumed), {micro} microbatches, step ms "
        f"{[round(x, 1) for x in step_ms]}, {nv} valid batches in {rec['valid_s']} s, WER {rec['wer']}, "
        f"peak memory {train_peak / 2**30:.2f} GiB, {n_params:,} params, losses "
        f"{[round(x, 3) for x in losses]}, launches {train_launches}; {stats}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    repro = train_reproducibility(dev, args, root, "recipe transformer CTC")
    secs["reproducibility"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the fp32 comparisons run the model with absolute positions (the
    # trained weights without the relative leaves): the relative
    # attention's kernels take bf16 alone (they are held in situ below)
    abs_cfg = copy.deepcopy(cfg)
    model_section(abs_cfg)["encoder_pos_type"] = "abs"
    cpu_steps = compare_train_steps_card_cpu(dev, abs_cfg, without_relative_leaves(tree), "transformer CTC")
    torch.cuda.empty_cache()
    in_situ = hold_attention_in_situ(dev, cfg, tree, layers, "transformer CTC")
    torch.cuda.empty_cache()
    breakdown = time_ctc_loss(dev, cfg, tree)
    del tree
    torch.cuda.empty_cache()

    # decode the test split at the yaml's beam, alone and with the LM, with
    # the seeded peaked weights
    task = setup_task(cfg)
    seeded_checkpoint(task, os.path.join(save_dir, "checkpoint_seeded"), 23, CTC_SEEDED_PEAK)
    del task
    dec_args = args + ["checkpoint.restore_file=checkpoint_seeded"]
    calls = []
    run_async = CTCPrefixBeamSearchDecoder.decode_async

    def counted_async(self, batch, *a, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = run_async(self, batch, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        calls.append((tuple(batch["src_frames"].shape), syncs))
        return handle

    class Elapsed(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Recognized"):
                rec["elapsed"] = record.args[1]

    handler = Elapsed()
    logging.getLogger("espresso_tpu_torch.recognize").addHandler(handler)
    decodes, hyps = {}, {}
    audio_s = corpus["valid"]["audio_s"]
    try:
        CTCPrefixBeamSearchDecoder.decode_async = counted_async
        for tag, extra in (("beam", []), ("beam_lm", [f"generation.lm_path={lm_dir}", "generation.lm_weight=0.4"])):
            out_dir = os.path.join(root, f"decode_{tag}")
            for f in kernels.values():
                f.launches = 0
            calls.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = speech_recognize.main(dec_args + extra + ["dataset.gen_subset=test",
                                                            f"generation.results_path={out_dir}"], device=dev)
            torch.cuda.synchronize()
            secs[f"decode_{tag}"] = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            syncs = sum(s for _, s in calls)
            counts = {name: f.launches for name, f in kernels.items()}
            want = {"fbank": len(calls), "rel_attention": layers * len(calls), "rel_attention_train_fwd": 0,
                    "rel_attention_train_bwd": 0}
            if files != ["aligned_results.txt", "cer", "decoded_results.txt", "wer"] \
                    or res["num_utts"] != TRANSFORMER_CORPUS["valid"] or counts != want or syncs:
                raise AssertionError(f"recipe transformer CTC {tag} decode: files {files}, result {res}, "
                                     f"launches {counts} (want {want}), host syncs {calls}")
            with open(os.path.join(out_dir, "decoded_results.txt")) as f:
                hyps[tag] = f.read()
            decodes[tag] = dict(result=res, batches=[s for s, _ in calls], host_syncs=syncs, launches=counts,
                                elapsed_s=rec["elapsed"], rtfx=audio_s / rec["elapsed"],
                                peak_bytes=torch.cuda.max_memory_allocated(),
                                wer_file=open(os.path.join(out_dir, "wer")).read().strip())
            log(f"recipe transformer CTC {tag} decode on {card}: {res}, batches {decodes[tag]['batches']} in "
                f"{rec['elapsed']:.3f} s, RTFx {audio_s / rec['elapsed']:.2f}, host syncs {syncs}, launches "
                f"{counts}, peak memory {decodes[tag]['peak_bytes'] / 2**30:.2f} GiB; {decodes[tag]['wer_file']}")
    finally:
        CTCPrefixBeamSearchDecoder.decode_async = run_async
        logging.getLogger("espresso_tpu_torch.recognize").removeHandler(handler)
    lines = [line.rstrip("\n").partition(" ") for line in hyps["beam"].splitlines()]
    if hyps["beam"] != hyps["beam_lm"] or not all(h for _, _, h in lines):
        raise AssertionError("the prefix beam's hypotheses moved with the LM, which it does not read, or "
                             f"one is empty: {hyps}")

    # the hub on two WAVs against speech_recognize on a manifest of the same
    t0 = time.perf_counter()
    with open(os.path.join(data, "test.json")) as f:
        test = json.load(f)
    utts = sorted(test)[:2]
    with open(os.path.join(data, "hub.json"), "w") as f:
        json.dump({f"hub_utt{i:06d}": {"wave": test[u]["wave"]} for i, u in enumerate(utts)}, f)
    hub_dir = os.path.join(root, "decode_hub")
    speech_recognize.main(dec_args + ["dataset.gen_subset=hub", f"generation.results_path={hub_dir}"],
                          device=dev)
    batching = {f"dataset.{k}": v for k, v in recipe["dataset"].items() if k != "specaugment_config"}
    asr = hub.from_pretrained(save_dir, data_dir=data, beam=CTC_RECIPE["generation"]["beam"], device=dev,
                              **batching, **{"checkpoint.restore_file": "checkpoint_seeded"})
    got = asr.transcribe([test[u]["wave"] for u in utts])
    secs["hub"] = time.perf_counter() - t0
    with open(os.path.join(hub_dir, "decoded_results.txt")) as f:
        cli = dict(line.rstrip("\n").partition(" ")[::2] for line in f)
    want_hub = [cli[f"hub_utt{i:06d}"] for i in range(len(utts))]
    if got != want_hub or not all(got):
        raise AssertionError(f"CTC hub {got} != the CLI's {want_hub}, or empty")
    log(f"recipe transformer CTC hub: {utts} -> {got}, the CLI's hypotheses")
    del asr
    torch.cuda.empty_cache()
    sub = compare_ctc_beam_card_cpu(dev, abs_cfg, CTC_RECIPE["generation"]["beam"])
    torch.cuda.empty_cache()
    return dict(
        corpus=corpus, vocab=V, widths=widths, params=n_params, stage_s=secs, steps=n,
        microbatches=micro, update_freq=CTC_UPDATE_FREQ, train_ms_per_step=statistics.mean(step_ms),
        step_ms=step_ms, valid_batches=nv, valid_s=rec["valid_s"], valid_wer=rec["wer"], losses=losses,
        train_peak_bytes=train_peak, launches=dict(train=train_launches, **{
            tag: d["launches"] for tag, d in decodes.items()}),
        decodes=decodes, reproducibility=repro, card_vs_cpu_steps=cpu_steps, card_vs_cpu_beam=sub,
        in_situ=in_situ, microbatch_breakdown=breakdown, card=card,
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
    lm_tmp = tempfile.TemporaryDirectory()
    phase("recipe LM stage")
    recipe_lm_stage = run_recipe_lm(dev, lm_tmp.name, card)
    print(json.dumps({"recipe_lm": recipe_lm_stage}))
    torch.cuda.empty_cache()
    phase("recipe CLIs")
    with tempfile.TemporaryDirectory() as cli_tmp:
        recipe_cli = run_recipe_clis(dev, cli_tmp, card, recipe_lm_stage["lm_dir"])
    print(json.dumps({"recipe_cli": recipe_cli}))
    torch.cuda.empty_cache()
    phase("recipe LSTM encoder-decoder")
    with tempfile.TemporaryDirectory() as lstm_tmp:
        recipe_lstm_path = run_recipe_lstm(dev, lstm_tmp, card, recipe_lm_stage["lm_dir"])
    print(json.dumps({"recipe_lstm": recipe_lstm_path}))
    torch.cuda.empty_cache()
    phase("recipe transformer encoder-decoder")
    with tempfile.TemporaryDirectory() as transformer_tmp:
        recipe_transformer_path = run_recipe_transformer(dev, transformer_tmp, card, recipe_lm_stage["lm_dir"])
    print(json.dumps({"recipe_transformer": recipe_transformer_path}))
    torch.cuda.empty_cache()
    phase("recipe transformer CTC")
    with tempfile.TemporaryDirectory() as ctc_tmp:
        recipe_ctc_path = run_recipe_transformer_ctc(dev, ctc_tmp, card, recipe_lm_stage["lm_dir"])
    lm_tmp.cleanup()
    print(json.dumps({"recipe_transformer_ctc": recipe_ctc_path}))
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
            # the attention encoder-decoder's recipe: its train runs (a launch a
            # microbatch, two a valid batch) and its beam and beam_lm decodes
            **({f"recipe_lstm_{tag}_launches": v for tag, v in recipe_lstm_path["fbank_launches"].items()}
               if name == "fbank" else {}),
            # the transformer encoder-decoder's recipe: its train runs (B10 a
            # microbatch and two a valid batch, B2 and B3 a layer a
            # microbatch, B1 a layer a valid step and a greedy decode), its
            # beam and beam_lm decodes (B10 a batch, B1 a layer a batch), and
            # B1/B2/B3 held in situ
            **{f"recipe_transformer_{tag}_launches": counts[name]
               for tag, counts in recipe_transformer_path["launches"].items() if counts.get(name)},
            **({"recipe_transformer_in_situ_max_abs_err":
                recipe_transformer_path["in_situ"]["max_abs_err"][name]}
               if name in recipe_transformer_path["in_situ"]["max_abs_err"] else {}),
            # the Transformer-CTC recipe: its train runs (B10 a microbatch and
            # two a valid batch, B2 and B3 a layer a microbatch, B1 a layer a
            # valid step and a greedy decode), its prefix-beam decodes alone
            # and with the LM (B10 a batch, B1 a layer a batch), and B1/B2/B3
            # held in situ
            **{f"recipe_transformer_ctc_{tag}_launches": counts[name]
               for tag, counts in recipe_ctc_path["launches"].items() if counts.get(name)},
            **({"recipe_transformer_ctc_in_situ_max_abs_err": recipe_ctc_path["in_situ"]["max_abs_err"][name]}
               if name in recipe_ctc_path["in_situ"]["max_abs_err"] else {}),
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
