"""Checkpoint save/load with espresso policy semantics.

Counterpart of ``espresso_tpu/train/checkpoint.py``: the save policy
(``CheckpointManager``: best/last/epoch/every-N-updates/keep-K, reference
checkpoint_utils.py:35-186), resume (model, optimizer, lr count, epoch
iterator, best metric), averaging, and the same names: ``checkpoint_last``,
``checkpoint_best``, ``checkpoint{epoch}``, ``checkpoint_{epoch}_{updates}``,
``checkpoint_best_{metric}_{epoch}``, ``checkpoint_crash``.

A checkpoint is a directory holding ``state.npz`` (numpy's uncompressed
archive; orbax is JAX's) and ``host_state.json`` (JAX's keys: ``iterator``,
``plateau``, ``best``). The archive's arrays are keyed by their path in a
tree, ``/``-joined:

* ``params/...`` and ``batch_stats/...``: the fp32 master weights and the
  batch-norm statistics, keyed and laid out as the JAX model's flax tree
  (``bridge.flax_paths``, ``bridge.to_flax_layout``), so that averaging runs
  leaf by leaf as JAX's does and a decoder loads them with
  ``bridge.load_jax_variables``;
* ``ema_params/...`` (with an EMA), the same tree;
* ``opt_state/mu``, ``opt_state/nu`` (the flat Adam moments, in the model's
  parameter order), ``opt_state/count``, ``step``, ``overflow_count`` and
  ``rng`` (the step generator's state): what a resume needs to continue bit
  for bit.

A save is atomic: the directory is written under a temporary sibling name
and renamed over the target. The device-to-host copy happens before a save
returns (``train_state_arrays``); with ``async_write`` only the disk write
runs on a background thread, awaited by ``wait_for_async_saves``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import uuid
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from espresso_tpu_torch import bridge

logger = logging.getLogger(__name__)

STATE_FILE = "state.npz"
HOST_STATE_FILE = "host_state.json"


def _ckpt_path(save_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(save_dir), name)


# in-flight background writes (reference checkpoint_utils.py:549-577 keeps a
# background thread and awaits it at train end)
_ASYNC_WRITES: List[threading.Thread] = []
_ASYNC_ERRORS: List[BaseException] = []


def wait_for_async_saves() -> None:
    """Block until every pending background checkpoint write has finished;
    re-raise the first error one of them met."""
    while _ASYNC_WRITES:
        _ASYNC_WRITES.pop().join()
    if _ASYNC_ERRORS:
        err = _ASYNC_ERRORS[0]
        _ASYNC_ERRORS.clear()
        raise err


# ---------------------------------------------------------------------------
# the train state as a tree of host arrays
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory (a CPU tensor is copied too: a
    background write must not see the state's later updates)."""
    return t.detach().to("cpu", copy=True).numpy()


def _flax_leaf_arrays(flat: np.ndarray, model, prefix: str) -> Dict[str, np.ndarray]:
    """A flat parameter buffer (host, f32, in parameter order) as the flax
    tree's leaves in its layout (views, transposed where flax's layout
    differs), keyed ``prefix/path``."""
    paths, _ = bridge.flax_paths(model)
    out, off = {}, 0
    for name, p in model.named_parameters():
        n = p.numel()
        leaf = flat[off : off + n].reshape(tuple(p.shape))
        path = paths[name]
        out["/".join((prefix,) + path)] = bridge.to_flax_layout(path[-1], leaf)
        off += n
    return out


def flat_params_from_tree(tree: Mapping[str, Any], model) -> torch.Tensor:
    """The inverse of :func:`_flax_leaf_arrays`: a flax-layout tree (nested
    dicts) as one flat f32 tensor in the model's parameter order."""
    paths, _ = bridge.flax_paths(model)
    parts = []
    for name, p in model.named_parameters():
        node: Any = tree
        for k in paths[name]:
            node = node[k]
        arr = bridge.from_flax_layout(paths[name][-1], np.asarray(node, np.float32))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(paths[name])}: checkpoint {arr.shape} != model {tuple(p.shape)}")
        parts.append(torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1))
    return torch.cat(parts)


def _batch_stats_arrays(model) -> Dict[str, np.ndarray]:
    """The model's batch-norm statistics, f32 host copies keyed
    ``batch_stats/path`` as the flax tree."""
    _, stats = bridge.flax_paths(model)
    buffers = dict(model.named_buffers())
    return {"/".join(("batch_stats",) + path): _host(buffers[name].float()) for name, path in stats.items()}


def flax_variables(model) -> Dict[str, Dict[str, np.ndarray]]:
    """``model``'s weights and batch-norm statistics as a flax variable tree
    of host arrays, ``{"params": ..., "batch_stats": ...}``: what
    ``bridge.load_jax_variables`` takes."""
    params = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
    arrays = _flax_leaf_arrays(_host(params), model, "params")
    arrays.update(_batch_stats_arrays(model))
    tree = unflatten(arrays)
    tree.setdefault("batch_stats", {})
    return tree


def train_state_arrays(state, model, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The device-to-host copy of a ``TrainState`` (``train/trainer.py``),
    its model's batch-norm statistics and the step generator's state, as the
    flat ``path -> array`` dict a checkpoint stores. Synchronous: the state's
    buffers may change as soon as it returns."""
    out = _flax_leaf_arrays(_host(state.params), model, "params")
    out.update(_batch_stats_arrays(model))
    if state.ema_params is not None:
        out.update(_flax_leaf_arrays(_host(state.ema_params), model, "ema_params"))
    opt = state.opt_state
    out["opt_state/mu"] = _host(opt.mu)
    out["opt_state/nu"] = _host(opt.nu)
    out["opt_state/count"] = _host(opt.count)
    out["step"] = np.asarray(state.step, np.int64)
    if state.overflow_count is not None:
        out["overflow_count"] = _host(state.overflow_count)
    if generator is not None:
        out["rng"] = generator.get_state().numpy()
    return out


def unflatten(arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


@torch.no_grad()
def restore_train_state(state, model, tree: Mapping[str, Any],
                        generator: Optional[torch.Generator] = None) -> None:
    """Copy a checkpoint ``tree`` (``load_checkpoint_state``) into ``state``,
    ``model`` and ``generator`` in place. The model's parameters stay views
    of ``state.compute`` (itself ``state.params`` in f32): the masters are
    copied into their buffer and the compute copies cast from them, never
    rebound."""
    state.params.copy_(flat_params_from_tree(tree["params"], model).to(state.params.device))
    if state.compute is not state.params:
        state.compute.copy_(state.params)
    _, stats = bridge.flax_paths(model)
    buffers = dict(model.named_buffers())
    for name, path in stats.items():
        node: Any = tree["batch_stats"]
        for k in path:
            node = node[k]
        buffers[name].copy_(torch.from_numpy(np.asarray(node)))
    if state.ema_params is not None:
        src = tree.get("ema_params") or tree["params"]
        state.ema_params.copy_(flat_params_from_tree(src, model).to(state.ema_params.device))
    opt = tree["opt_state"]
    for name in ("mu", "nu", "count"):
        getattr(state.opt_state, name).copy_(torch.from_numpy(np.asarray(opt[name])))
    state.step = int(tree["step"])
    if state.overflow_count is not None and "overflow_count" in tree:
        state.overflow_count.copy_(torch.from_numpy(np.asarray(tree["overflow_count"])))
    if generator is not None and "rng" in tree:
        generator.set_state(torch.from_numpy(np.asarray(tree["rng"], np.uint8)))


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def _write(path: str, arrays: Mapping[str, Any], host_state: Dict[str, Any]) -> None:
    """Write the checkpoint under a temporary sibling, then rename it over
    ``path`` (the previous one is removed only once the new one is whole)."""
    parent, name = os.path.split(path)
    tmp = os.path.join(parent, f".{name}.tmp-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            np.savez(f, **arrays)
        with open(os.path.join(tmp, HOST_STATE_FILE), "w") as f:
            json.dump(host_state, f)
        old = None
        if os.path.exists(path):
            old = os.path.join(parent, f".{name}.old-{uuid.uuid4().hex[:8]}")
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint_state(
    path: str, state: Mapping[str, Any], host_state: Dict[str, Any], async_write: bool = False
) -> None:
    """Save the host arrays ``state`` (``train_state_arrays``, or any
    ``path -> array`` dict) and ``host_state`` as the checkpoint directory
    ``path``. With ``async_write`` the disk write runs on a background
    thread; an earlier write still in flight is awaited first."""
    path = os.path.abspath(path)
    wait_for_async_saves()
    if not async_write:
        _write(path, state, host_state)
        return

    def run():
        try:
            _write(path, state, host_state)
        except Exception as e:  # surfaced by wait_for_async_saves
            _ASYNC_ERRORS.append(e)

    t = threading.Thread(target=run, name="checkpoint-write", daemon=False)
    t.start()
    _ASYNC_WRITES.append(t)


def load_raw_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's arrays as a tree of nested dicts (``params``,
    ``batch_stats``, ``opt_state``, ``step``, ...), as JAX's raw restore
    returns them."""
    wait_for_async_saves()
    with np.load(os.path.join(os.path.abspath(path), STATE_FILE)) as z:
        return unflatten({k: z[k] for k in z.files})


def load_checkpoint_state(path: str):
    """(tree, host_state) of the checkpoint directory ``path``."""
    tree = load_raw_checkpoint(path)
    host_path = os.path.join(os.path.abspath(path), HOST_STATE_FILE)
    host_state: Dict[str, Any] = {}
    if os.path.exists(host_path):
        with open(host_path) as f:
            host_state = json.load(f)
    return tree, host_state


class CheckpointManager:
    """Save policy driver (reference checkpoint_utils.save_checkpoint
    :35-186); ``state`` is the host arrays of ``train_state_arrays``."""

    def __init__(self, cfg, maximize_best: Optional[bool] = None):
        self.cfg = cfg.checkpoint
        self.save_dir = self.cfg.save_dir
        self.maximize_best = (
            maximize_best
            if maximize_best is not None
            else self.cfg.maximize_best_checkpoint_metric
        )
        self.best: Optional[float] = None
        self.async_write = getattr(self.cfg, "write_checkpoints_asynchronously", False)
        os.makedirs(self.save_dir, exist_ok=True)

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        return metric > self.best if self.maximize_best else metric < self.best

    def _save(self, name: str, state, host_state) -> None:
        save_checkpoint_state(
            _ckpt_path(self.save_dir, name), state, host_state, async_write=self.async_write
        )

    def save_epoch(
        self,
        state,
        host_state: Dict[str, Any],
        epoch: int,
        val_metric: Optional[float] = None,
        end_of_epoch: bool = True,
        updates: int = 0,
    ) -> List[str]:
        if self.cfg.no_save:
            return []
        cfg = self.cfg
        saved = []
        host_state = dict(host_state)
        host_state["best"] = self.best
        if val_metric is not None and self._is_better(val_metric):
            self.best = val_metric
            host_state["best"] = self.best
            self._save("checkpoint_best", state, host_state)
            saved.append("checkpoint_best")
        if val_metric is not None and cfg.keep_best_checkpoints > 0:
            # keep the N best metric-named checkpoints
            name = f"checkpoint_best_{val_metric:.4f}_{epoch}"
            self._save(name, state, host_state)
            saved.append(name)
            best_ckpts = []
            for entry in os.listdir(self.save_dir):
                m = re.fullmatch(r"checkpoint_best_([\d.eE+-]+)_(\d+)", entry)
                if m:
                    best_ckpts.append((float(m.group(1)), entry))
            best_ckpts.sort(key=lambda t: t[0], reverse=self.maximize_best)
            wait_for_async_saves()
            for _, entry in best_ckpts[cfg.keep_best_checkpoints :]:
                shutil.rmtree(_ckpt_path(self.save_dir, entry), ignore_errors=True)
        if end_of_epoch and cfg.save_interval > 0 and epoch % cfg.save_interval == 0:
            name = f"checkpoint{epoch}"
            self._save(name, state, host_state)
            saved.append(name)
        if (
            not end_of_epoch
            and cfg.save_interval_updates > 0
            and updates % cfg.save_interval_updates == 0
        ):
            name = f"checkpoint_{epoch}_{updates}"
            self._save(name, state, host_state)
            saved.append(name)
        self._save("checkpoint_last", state, host_state)
        saved.append("checkpoint_last")
        self._prune()
        return saved

    def _prune(self) -> None:
        keep = self.cfg.keep_last_epochs
        if keep <= 0:
            return
        epochs = []
        for name in os.listdir(self.save_dir):
            m = re.fullmatch(r"checkpoint(\d+)", name)
            if m:
                epochs.append(int(m.group(1)))
        for old in sorted(epochs)[:-keep]:
            shutil.rmtree(_ckpt_path(self.save_dir, f"checkpoint{old}"), ignore_errors=True)

    def restore_path(self) -> Optional[str]:
        path = _ckpt_path(self.save_dir, self.cfg.restore_file)
        return path if os.path.exists(path) else None


def average_trees(trees: List[Mapping[str, Any]]) -> Dict[str, Any]:
    """The leaf-wise mean of ``params`` trees: float64 sums in the given
    order, divided by their number, rounded to float32 (as JAX's averaging
    computes it)."""
    flat = [flatten_tree(t) for t in trees]
    keys = list(flat[0])
    for f in flat[1:]:
        if set(f) != set(keys):
            raise ValueError("checkpoints to average hold different params trees")
    acc = {k: np.asarray(flat[0][k], np.float64) for k in keys}
    for f in flat[1:]:
        for k in keys:
            acc[k] = acc[k] + np.asarray(f[k], np.float64)
    return unflatten({k: (a / len(trees)).astype(np.float32) for k, a in acc.items()})


def average_checkpoints(paths: List[str]) -> Dict[str, Any]:
    """Parameter averaging (reference scripts/average_checkpoints.py): the
    last checkpoint's tree with the mean of every checkpoint's ``params``."""
    assert paths
    trees = [load_raw_checkpoint(p) for p in paths]
    out = dict(trees[-1])
    out["params"] = average_trees([t["params"] for t in trees])
    return out
