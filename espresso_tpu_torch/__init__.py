"""espresso_tpu_torch: the PyTorch/CUDA port of espresso_tpu for NVIDIA Hopper.

The JAX package ``espresso_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

- ``espresso_tpu_torch.ops``     : masking helpers, the Hopper kernels' Python
  wrappers (each beside its plain PyTorch version), the CUDA gate
- ``espresso_tpu_torch.modules`` : nn.Module building blocks (attention,
  conformer pieces, conv frontend, positional tables, LSTM gates)
- ``espresso_tpu_torch.models``  : Conformer encoder, Transducer model
- ``espresso_tpu_torch.decode``  : batched transducer greedy decoding
- ``espresso_tpu_torch.data``    : the symbol dictionary (no JAX import)
- ``espresso_tpu_torch.bridge``  : load a flax variable tree into a port model
- ``csrc/``                      : CUDA C++ sources for ``sm_90a``, built at
  first use (``ops/cuda_build.py``)

Nothing here imports ``jax``, ``flax`` or ``espresso_tpu``.
"""

__version__ = "0.1.0"
