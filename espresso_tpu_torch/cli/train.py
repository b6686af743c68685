"""The train CLI's batch transfer.

Counterpart of ``put_batch`` in ``espresso_tpu/cli/train.py`` (train.py:54-62):
a collated numpy group (``AsrDataset.collate_group``) becomes tensors on the
device. The rest of that CLI (the epoch loop, validation with WER,
checkpoints, logging) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def put_batch(batch: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """The group's arrays as tensors on ``device`` (the card unless the
    caller asks for the CPU); ``utt_ids`` and the counts (``ntokens``,
    ``nsentences``) stay on the host and are left out, as in the reference.
    On a CUDA device each array is staged in pinned host memory and copied
    with ``non_blocking=True``, so the copies run on the current stream and
    the host goes on (a pageable source would make each copy synchronous)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out
