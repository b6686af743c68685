"""espresso_tpu_torch: the PyTorch/CUDA port of espresso_tpu for NVIDIA Hopper.

The JAX package ``espresso_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

- ``espresso_tpu_torch.ops``     : masking helpers, the Hopper kernels' Python
  wrappers (each beside its plain PyTorch version), the CUDA gate, the
  RNNT loss and its DP
- ``espresso_tpu_torch.modules`` : nn.Module building blocks (attention,
  conformer pieces, conv frontend, positional tables, LSTM gates and
  sequence layers, Bahdanau and Luong attention, flax-style batch norm and
  dropout)
- ``espresso_tpu_torch.models``  : the conformer or transformer encoder, the
  Transducer model, the transformer and LSTM attention encoder-decoders,
  the LSTM LM
- ``espresso_tpu_torch.decode``  : batched transducer greedy and beam
  decoding; the encoder-decoder's greedy and beam decoding and its adapters
- ``espresso_tpu_torch.train``   : the train step (adam, clip, overflow skip,
  EMA) and the learning-rate schedules
- ``espresso_tpu_torch.criterions``, ``espresso_tpu_torch.config``,
  ``espresso_tpu_torch.registry``, ``espresso_tpu_torch.tasks``: the
  transducer criterion, the recipe's config tree (yaml and dotted
  overrides), the registries and presets, the speech recognition task
- ``espresso_tpu_torch.data``    : the host data path in numpy: manifests,
  Kaldi IO, WAV reading, tokenizers, the symbol dictionary, batch packing,
  the dataset and its checkpointable iterators
- ``espresso_tpu_torch.clib``    : host C++ (batch packing, edit counts),
  built by g++ at first use
- ``espresso_tpu_torch.cli``     : ``train.put_batch``, a collated group to
  the card
- ``espresso_tpu_torch.bridge``  : load a flax variable tree into a port model
- ``csrc/``                      : CUDA C++ sources for ``sm_90a``, built at
  first use (``ops/cuda_build.py``)

Nothing here imports ``jax``, ``flax`` or ``espresso_tpu``.
"""

__version__ = "0.1.0"
