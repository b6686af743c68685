"""CUDA gate for the port's Hopper kernels.

Counterpart of ``espresso_tpu/ops/backend.py::backend_is_tpu``. The kernels
are built for ``sm_90a`` only, so a GPU path asks ``require_cuda()`` and
fails loudly on anything else; there is no CPU fallback on the GPU path.
"""

from __future__ import annotations

import torch

REQUIRED_CAPABILITY = (9, 0)


def require_cuda(device: int = 0) -> torch.device:
    """Return ``cuda:<device>`` or raise unless it is a Hopper (9, 0) card."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's kernels need an H100")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"device {device} has compute capability {cap}; the kernels are "
            f"built for sm_90a and need {REQUIRED_CAPABILITY}"
        )
    return torch.device("cuda", device)
