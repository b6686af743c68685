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
  * LSTM gate order (i, f, g, o) is the same in both; a sequence layer's
    recurrent ``hh_kernel`` [H, 4H] keeps its name and is transposed as a
    Dense kernel is

It raises if a port tensor is left unfilled, a JAX leaf goes unused, or a
shape disagrees. ``flax_leaves`` names the flax leaf of each port parameter
and ``to_flax_layout`` / ``from_flax_layout`` move a tensor between the two
layouts, for code that follows flax's leaf names and layouts (quant noise
and weight quantization, ``ops/quantization.py``); ``flax_paths`` gives
each parameter's and batch-norm statistic's path in the flax tree (the
inverse of ``port_key``), which the checkpoints key their arrays by
(``train/checkpoint.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# flax submodule name -> port submodule name, by the name of the parent (a
# pattern the whole parent name matches)
_RENAMES = {
    "": {r"declayer(\d+)": r"decoder_layers.\1"},
    "conv": {r"Conv_(\d+)": r"convs.\1", r"BatchNorm_(\d+)": r"norms.\1"},
    "encoder": {r"layer(\d+)": r"layers.\1"},
    # the transformer encoder layer's auto-named FFN (a conformer layer has
    # no Dense directly under it)
    r"layer\d+": {"Dense_0": "fc1", "Dense_1": "fc2"},
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
    # the LSTM decoder of the LM and of the speech LSTM (models/speech_lstm.py)
    "decoder": {r"cell(\d+)_ih": r"cells_ih.\1", r"cell(\d+)_hh": r"cells_hh.\1"},
}
_LEAVES = {
    "scale": "weight",
    "bias": "bias",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}
# flax kernel layout -> torch weight layout, by rank, and back
_KERNEL_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_KERNEL_PERM_INV = {n: tuple(int(i) for i in np.argsort(p)) for n, p in _KERNEL_PERM.items()}
_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d)
# flax leaves held in the torch layout
_KERNEL_LEAVES = ("kernel", "hh_kernel")


def flax_leaves(model: nn.Module) -> Dict[str, str]:
    """The flax leaf name of each of ``model``'s parameters, in parameter
    order: ``kernel`` for the weight of a Linear or a convolution (held in
    the torch layout), ``embedding`` for an Embedding's table, ``scale`` for
    any other weight (the norms'), else the parameter's own name."""
    leaves = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                leaf = "kernel" if isinstance(mod, _KERNEL_MODULES) else (
                    "embedding" if isinstance(mod, nn.Embedding) else "scale")
            leaves[f"{mname}.{pname}" if mname else pname] = leaf
    return {name: leaves[name] for name, _ in model.named_parameters()}


def _permute(x, perm):
    return x.permute(*perm) if isinstance(x, torch.Tensor) else np.transpose(x, perm)


def to_flax_layout(leaf: str, x):
    """A port parameter (tensor or array) in its flax leaf's layout."""
    return _permute(x, _KERNEL_PERM_INV[x.ndim]) if leaf in _KERNEL_LEAVES else x


def from_flax_layout(leaf: str, x):
    """The inverse of :func:`to_flax_layout`."""
    return _permute(x, _KERNEL_PERM[x.ndim]) if leaf in _KERNEL_LEAVES else x


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _renames(parent: str, table: Mapping[str, Any], empty):
    """The entry of ``table`` whose pattern the flax name ``parent`` matches
    whole, else ``empty``."""
    return next((v for k, v in table.items() if re.fullmatch(k, parent)), empty)


def port_key(path: Tuple[str, ...]) -> str:
    """flax path (module names..., leaf) -> port state_dict key."""
    out = []
    for i, name in enumerate(path[:-1]):
        parent = path[i - 1] if i > 0 else ""
        for pat, repl in _renames(parent, _RENAMES, {}).items():
            new = re.sub(f"^{pat}$", repl, name)
            if new != name:
                name = new
                break
        out.append(name)
    leaf = path[-1]
    out.append("weight" if leaf == "kernel" else _LEAVES.get(leaf, leaf))
    return ".".join(out)


# port submodule name -> flax name, by the flax name of the parent: the
# inverse of _RENAMES (a port name may span two components, "layers.3")
_INVERSE = {
    parent: [
        (re.compile(repl.replace(".", r"\.").replace(r"\1", r"(\d+)") + r"(?=\.|$)"),
         pat.replace(r"(\d+)", r"\1"))
        for pat, repl in table.items()
    ]
    for parent, table in _RENAMES.items()
}
_BUFFER_LEAVES = {"running_mean": "mean", "running_var": "var"}


def flax_path(key: str, leaf: str) -> Tuple[str, ...]:
    """The flax path (module names..., ``leaf``) of the port state_dict
    ``key``: ``port_key(flax_path(key, leaf)) == key``."""
    parts = key.split(".")[:-1]
    out = []
    i = 0
    while i < len(parts):
        rest = ".".join(parts[i:])
        for rx, flax_name in _renames(out[-1] if out else "", _INVERSE, ()):
            m = rx.match(rest)
            if m:
                out.append(m.expand(flax_name))
                i += m.group(0).count(".") + 1
                break
        else:
            out.append(parts[i])
            i += 1
    return tuple(out) + (leaf,)


def flax_paths(model: nn.Module) -> Tuple[Dict[str, Tuple[str, ...]], Dict[str, Tuple[str, ...]]]:
    """(params, batch_stats): each parameter's flax path, in parameter
    order, and each batch-norm statistic's (``running_mean`` / ``running_var``
    as ``mean`` / ``var``), in buffer order."""
    params = {name: flax_path(name, leaf) for name, leaf in flax_leaves(model).items()}
    stats = {
        name: flax_path(name, _BUFFER_LEAVES[name.rsplit(".", 1)[-1]])
        for name, _ in model.named_buffers()
        if name.rsplit(".", 1)[-1] in _BUFFER_LEAVES
    }
    return params, stats


def jax_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Translate a flax variable tree into port state_dict arrays (float32)."""
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] in _KERNEL_LEAVES:
                arr = arr.transpose(_KERNEL_PERM[arr.ndim])
            key = port_key(path)
            if key in out:
                raise ValueError(f"two JAX leaves map to {key}")
            out[key] = np.ascontiguousarray(arr).reshape(arr.shape)  # a scalar stays 0-d
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
