"""espresso_tpu_torch: the PyTorch/CUDA port of espresso_tpu for NVIDIA Hopper.

The JAX package ``espresso_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

- ``espresso_tpu_torch.ops``     : masking helpers, the Hopper kernels' Python
  wrappers (each beside its plain PyTorch version), the CUDA gate, the
  RNNT loss and its DP
- ``espresso_tpu_torch.modules`` : nn.Module building blocks (attention,
  conformer pieces, conv frontend, positional tables, LSTM gates, flax-style
  batch norm and dropout)
- ``espresso_tpu_torch.models``  : Conformer encoder, Transducer model
- ``espresso_tpu_torch.decode``  : batched transducer greedy and beam decoding
- ``espresso_tpu_torch.train``   : the train step (adam, clip, overflow skip,
  EMA) and the learning-rate schedules
- ``espresso_tpu_torch.criterions``, ``espresso_tpu_torch.config``: the
  transducer criterion and the config sections the train step reads
- ``espresso_tpu_torch.data``    : the symbol dictionary (no JAX import)
- ``espresso_tpu_torch.bridge``  : load a flax variable tree into a port model
- ``csrc/``                      : CUDA C++ sources for ``sm_90a``, built at
  first use (``ops/cuda_build.py``)

Nothing here imports ``jax``, ``flax`` or ``espresso_tpu``.
"""

__version__ = "0.1.0"
