"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's greedy serving path (``espresso_tpu_torch``) at the
flagship Conformer-Transducer's full width and checks its Hopper kernel:

1. requires a CUDA card of capability (9, 0); builds every kernel of the
   path from ``espresso_tpu_torch/csrc`` with nvcc (sm_90a) and prints the
   build time;
2. holds each kernel against its plain PyTorch version on the card, in bf16
   with ragged key masks, at the flagship shape and at edge lengths, and
   times both at the flagship shape;
3. builds the flagship model (16 conformer layers, d=512, ffn 2048, 8 heads,
   depthwise kernel 31, relative positions, batch norm; 2x512 LSTM
   prediction net, joint 512, V=1024) from a seeded init, casts it to bf16,
   and decodes B=256 utterances of T=624 frames with the greedy decoder
   (one warm-up batch, three timed ones), counting kernel launches;
4. checks the outputs: finite, well-formed hypotheses, and the encoder
   output on a sub-batch against the same model run through the plain
   attention version.

Any failure raises (nonzero exit) before the result lines. Prints, as its
last three lines, the kernel summary JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Exits nonzero without a result when
no CUDA card is present.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = dict(B=256, T_FRAMES=624, FEAT=80, VOCAB=1024)
ATTN_SHAPES = [(256, 156), (4, 2), (4, 37), (2, 1024)]  # (B, T') at H=8, d=64
H, D = 8, 512
FRAME_SHIFT_S = 0.01
# the encoder output after 16 bf16 layers, kernel vs plain attention: each
# layer may flip the bf16 rounding of a few scores, which the residual stream
# carries on; the final LayerNorm output is O(1), so 0.25 is ~16 bf16 ulps at
# magnitude 2-4 and far below the O(1) error of a wrong kernel
ENCODER_ATOL = 0.25


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def attn_inputs(B: int, T: int, seed: int, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    key_valid = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(B, T, D), mk(2 * T - 1, D), key_valid


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


def check_attention(dev):
    from espresso_tpu_torch.ops.attention_kernels import rel_attention, rel_attention_reference

    scale = (D // H) ** -0.5
    worst, flagship_ms, plain_ms = 0.0, None, None
    for i, (B, T) in enumerate(ATTN_SHAPES):
        args = attn_inputs(B, T, seed=i, dev=dev) + (H, scale)
        out = rel_attention(*args)
        torch.cuda.synchronize()
        ref = rel_attention_reference(*args)
        err = (out.float() - ref.float()).abs().max().item()
        bound = 2 * bf16_ulp(ref.float().abs().max().item())
        finite = bool(torch.isfinite(out.float()).all())
        log(f"rel_attention B={B} T'={T}: max_abs_err {err} (bound {bound}, 2 bf16 ulps)")
        if not finite or err > bound:
            raise AssertionError(f"rel_attention disagrees at B={B} T'={T}: {err} > {bound}")
        worst = max(worst, err)
        if (B, T) == ATTN_SHAPES[0]:
            flagship_ms = median_ms(lambda: rel_attention(*args))
            plain_ms = median_ms(lambda: rel_attention_reference(*args))
            log(
                f"rel_attention flagship: kernel {flagship_ms} ms, plain {plain_ms} ms "
                "(median of 20 samples of 10 back-to-back calls)"
            )
    return worst, flagship_ms, plain_ms


def flagship_model(dev):
    from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig
    from espresso_tpu_torch.models.transducer import TransducerConfig, TransducerModel

    cfg = TransducerConfig(
        feat_dim=FLAGSHIP["FEAT"],
        vocab_size=FLAGSHIP["VOCAB"],
        encoder=SpeechTransformerConfig(
            encoder_embed_dim=512, encoder_ffn_dim=2048, encoder_layers=16,
            encoder_heads=8, depthwise_conv_kernel_size=31,
        ),
        pred_embed_dim=512, pred_hidden_size=512, pred_layers=2, joint_dim=512,
    )
    torch.manual_seed(0)
    # bf16 inference: every float parameter and batch-norm statistic
    return TransducerModel(cfg).to(dev, torch.bfloat16).eval()


@contextlib.contextmanager
def plain_attention():
    """Route the attention module to the plain version (comparison only)."""
    from espresso_tpu_torch.modules import attention
    from espresso_tpu_torch.ops.attention_kernels import rel_attention_reference

    saved = attention.rel_attention
    attention.rel_attention = rel_attention_reference
    try:
        yield
    finally:
        attention.rel_attention = saved


def run_decode(dev):
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_greedy import TransducerGreedyDecoder
    from espresso_tpu_torch.ops.attention_kernels import rel_attention

    B, T = FLAGSHIP["B"], FLAGSHIP["T_FRAMES"]
    model = flagship_model(dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((B, T, FLAGSHIP["FEAT"]), np.float32))
    frames = frames.to(dev, torch.bfloat16)
    lengths = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    lengths = torch.from_numpy(lengths).to(dev)
    batch = {"src_frames": frames, "src_lengths": lengths}
    decoder = TransducerGreedyDecoder(
        model, AsrDictionary(enable_bos=True), max_out_factor=0.35
    )
    L_max = max(int(T * 0.35), 8)

    t0 = time.perf_counter()
    decoder.decode(batch)
    torch.cuda.synchronize()
    log(f"warm-up batch {time.perf_counter() - t0:.3f} s")

    iters = 3
    torch.cuda.reset_peak_memory_stats(dev)
    rel_attention.launches = 0
    t0 = time.perf_counter()
    handles = [decoder.decode_async(batch) for _ in range(iters)]
    hyps = [decoder.collect(h) for h in handles]
    wall = time.perf_counter() - t0
    launches = rel_attention.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_layers = len(model.encoder.layers)
    if launches != n_layers * iters:
        raise AssertionError(f"rel_attention launched {launches} times, want {n_layers * iters}")

    # encoder time alone (outside the counted window)
    with torch.no_grad():
        enc_ms = median_ms(lambda: model.encode(frames, lengths), samples=3, reps=1)
    batch_s = wall / iters
    rtfx = iters * B * T * FRAME_SHIFT_S / wall
    log(
        f"greedy decode B={B} T={T}: {wall:.4f} s for {iters} batches, RTFx {rtfx:.1f}; "
        f"encoder {enc_ms:.2f} ms/batch, frame loop (batch - encoder) "
        f"{batch_s * 1e3 - enc_ms:.2f} ms/batch; peak memory {peak_gb:.2f} GB"
    )

    # outputs: well-formed hypotheses, finite scores
    for batch_hyps in hyps:
        for (h,) in batch_hyps:
            toks = h["tokens"]
            if not (math.isfinite(h["score"]) and len(toks) <= L_max):
                raise AssertionError(f"bad hypothesis {h}")
            if len(toks) and (toks.min() < 0 or toks.max() >= FLAGSHIP["VOCAB"]):
                raise AssertionError(f"token out of range {toks}")
    emitted = sum(len(h[0]["tokens"]) for h in hyps[0])
    log(f"tokens emitted per batch: {emitted} (L_max {L_max} per utterance)")

    # encoder output on a sub-batch: kernel vs plain attention
    sub = slice(0, 8)
    with torch.no_grad():
        out = model.encode(frames[sub], lengths[sub]).encoder_out.float()
        with plain_attention():
            ref = model.encode(frames[sub], lengths[sub]).encoder_out.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("encoder output not finite")
    enc_err = (out - ref).abs().max().item()
    log(f"encoder sub-batch kernel vs plain: max_abs_err {enc_err} (bound {ENCODER_ATOL})")
    if enc_err > ENCODER_ATOL:
        raise AssertionError(f"encoder output disagrees: {enc_err} > {ENCODER_ATOL}")
    return dict(
        launches=launches, rtfx=rtfx, wall_s=wall, encoder_ms=enc_ms,
        frame_loop_ms=batch_s * 1e3 - enc_ms, peak_gb=peak_gb,
        encoder_max_abs_err=enc_err, tokens_per_batch=emitted,
    )


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA card available")
        return 1
    from espresso_tpu_torch.ops import attention_kernels
    from espresso_tpu_torch.ops.backend import require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    nvcc_log = attention_kernels.build()
    log(f"kernel build {time.perf_counter() - t0:.2f} s\n{nvcc_log}")

    err, kernel_ms, plain_ms = check_attention(dev)
    decode = run_decode(dev)
    print(json.dumps({"decode": decode, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "rel_attention",
        "route": "cuda",
        "source": "espresso_tpu_torch/csrc/rel_attention.cu",
        "replaces": "espresso_tpu/ops/attention_kernels.py:185",
        "launches": decode["launches"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
