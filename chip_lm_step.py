"""Time the recipe LM's train step on one NVIDIA H100, with its LSTM cells
as ``torch.lstm_cell`` (the port's: the two products and one fused gate
kernel, forward and backward) and as the composed gate ops of
``modules/lstm.py::lstm_gates`` (sigmoid, tanh, products and sums, one
kernel each), in turns.

    cd <checkout> && python3 <this repo>/chip_lm_step.py

Imports ``espresso_tpu_torch`` from the current directory. The LM is the
recipe's ``lstm_lm_librispeech`` (4 x 800, V = 5,003, dropout 0, seeded
weights), one batch of 16 rows of 512 tokens (the recipe LM stage of
``chip_smoke.py``), bf16 compute on fp32 masters, adam at lr 0.001. Each
variant runs a warm-up step, then 3 steps timed by the host clock between
synchronisations, twice in turns (cell, composed, cell, composed). Prints a
line a round, then one JSON line of the ms a step and the card's name and
power limit. Exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

V, ROWS, TOKENS, STEPS = 5003, 16, 512, 3


class _Dictionary:
    def pad(self):
        return 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_lm_step: no CUDA card available", file=sys.stderr)
        return 1
    from espresso_tpu_torch.config import EspressoConfig
    from espresso_tpu_torch.criterions import CrossEntropyV2
    from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel, LSTMLMConfig
    from espresso_tpu_torch.modules.lstm import lstm_gates
    from espresso_tpu_torch.train.trainer import build_optimizer, create_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = EspressoConfig()
    cfg.criterion.name = "cross_entropy_v2"
    cfg.optimization.lr = [0.001]
    torch.manual_seed(0)
    model = LSTMLanguageModel(LSTMLMConfig(vocab_size=V, embed_dim=800, hidden_size=800, out_embed_dim=800,
                                           num_layers=4, dropout=0.0)).to(dev)
    optimizer, _ = build_optimizer(cfg)
    state = create_train_state(model, optimizer, cfg)
    step = make_train_step(model, CrossEntropyV2(cfg.criterion, _Dictionary()), optimizer, cfg)
    tok = torch.randint(3, V, (1, ROWS, TOKENS), generator=torch.Generator().manual_seed(1))
    batch = {"prev_output_tokens": tok, "target": tok.roll(-1, -1), "weight": torch.ones(1, ROWS),
             "tgt_lengths": torch.full((1, ROWS), TOKENS)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    cell = torch.lstm_cell

    def composed(x, hc, w_ih, w_hh, b_ih, b_hh):
        return lstm_gates(x @ w_ih.t() + b_ih + hc[0] @ w_hh.t() + b_hh, hc[0], hc[1])

    ms = {"lstm_cell": [], "composed": []}
    try:
        for rnd in range(2):
            for name, fn in (("lstm_cell", cell), ("composed", composed)):
                torch.lstm_cell = fn
                state, m = step(state, batch, gen)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(STEPS):
                    state, m = step(state, batch, gen)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t) / STEPS * 1e3)
                loss = (m["loss"] / m["sample_size"]).item()
                print(f"round {rnd} {name}: {ms[name][-1]:.1f} ms a step, loss {loss:.4f}", flush=True)
    finally:
        torch.lstm_cell = cell
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"ms_per_step": ms, "rows": ROWS, "tokens": TOKENS, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
