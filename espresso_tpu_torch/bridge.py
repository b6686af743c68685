"""Load a flax variable tree into a port model.

``load_jax_variables(model, variables)`` takes the JAX package's
``{"params": ..., "batch_stats": ...}`` tree as nested dicts of numpy arrays
and fills the port model's ``state_dict`` in place. It is the inverse of the
layout mapping in ``espresso_tpu/cli/convert_espresso_checkpoint.py:7-17``:

  * Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in]
  * Conv2d ``kernel`` HWIO -> ``weight`` OIHW
  * depthwise Conv ``kernel`` [K, 1, D] -> Conv1d ``weight`` [D, 1, K]
  * LayerNorm / BatchNorm ``scale`` -> ``weight``; ``batch_stats``
    ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  * Embed ``embedding`` -> ``weight``
  * LSTM gate order (i, f, g, o) is the same in both

It raises if a port tensor is left unfilled, a JAX leaf goes unused, or a
shape disagrees.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# flax submodule name -> port submodule name, by the name of the parent
_RENAMES = {
    "conv": {r"Conv_(\d+)": r"convs.\1", r"BatchNorm_(\d+)": r"norms.\1"},
    "encoder": {r"layer(\d+)": r"layers.\1"},
    "ffn1": {"LayerNorm_0": "layer_norm", "Dense_0": "fc1", "Dense_1": "fc2"},
    "ffn2": {"LayerNorm_0": "layer_norm", "Dense_0": "fc1", "Dense_1": "fc2"},
    "conv_module": {
        "LayerNorm_0": "layer_norm",
        "Dense_0": "pointwise_conv1",
        "Conv_0": "depthwise_conv",
        "BatchNorm_0": "batch_norm",
        "Dense_1": "pointwise_conv2",
    },
    "predictor": {r"cell(\d+)_ih": r"cells_ih.\1", r"cell(\d+)_hh": r"cells_hh.\1"},
}
_LEAVES = {
    "scale": "weight",
    "bias": "bias",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}
# flax kernel layout -> torch weight layout, by rank
_KERNEL_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def port_key(path: Tuple[str, ...]) -> str:
    """flax path (module names..., leaf) -> port state_dict key."""
    out = []
    for i, name in enumerate(path[:-1]):
        parent = path[i - 1] if i > 0 else ""
        for pat, repl in _RENAMES.get(parent, {}).items():
            new = re.sub(f"^{pat}$", repl, name)
            if new != name:
                name = new
                break
        out.append(name)
    leaf = path[-1]
    out.append("weight" if leaf == "kernel" else _LEAVES.get(leaf, leaf))
    return ".".join(out)


def jax_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Translate a flax variable tree into port state_dict arrays (float32)."""
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(_KERNEL_PERM[arr.ndim])
            key = port_key(path)
            if key in out:
                raise ValueError(f"two JAX leaves map to {key}")
            out[key] = np.ascontiguousarray(arr)
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    return out


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy the JAX variables into ``model`` in place (keeping its dtype and
    device); returns the model."""
    arrays = jax_state_dict(variables)
    state = {
        k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")
    }
    unused = sorted(set(arrays) - set(state))
    unfilled = sorted(set(state) - set(arrays))
    if unused or unfilled:
        raise ValueError(f"JAX leaves unused: {unused}; port tensors unfilled: {unfilled}")
    for key, arr in arrays.items():
        if tuple(state[key].shape) != arr.shape:
            raise ValueError(f"{key}: port {tuple(state[key].shape)} != JAX {arr.shape}")
        state[key].copy_(torch.tensor(arr))
    return model
