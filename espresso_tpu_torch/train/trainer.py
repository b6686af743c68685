"""The train step: the feature front, SpecAugment, quant noise, microbatch
accumulation, clip, overflow skip, the optimizer, EMA.

Counterpart of ``espresso_tpu/train/trainer.py``: ``build_optimizer``
(trainer.py:43-132: adam, adamw, adagrad, adadelta, adamax, sgd, nag and
momentum, each the optax chain on flat tensors; adafactor, its statistics
per parameter in the flax layout; composite, per-group optimizers by
top-level name), ``make_device_feature_fn`` (:135-180),
``make_train_step`` (:192-399), ``make_valid_step`` (:402-432) and
``create_train_state`` (:435-461). One step:

* per microbatch, in JAX's order (trainer.py:234-262): quant noise on the
  fp32 masters, cast to the compute copies (``optimization.quant_noise_pq >
  0``: one draw per microbatch; the noise never reaches the masters and the
  gradient reaches them as ``mask / (1 - p)`` times the noised weights');
  the feature front (a batch of ``src_waveforms`` / ``num_samples`` becomes
  log-mel ``src_frames`` / ``src_lengths`` on the device, with global CMVN
  and delta-deltas); f32; SpecAugment (``dataset.specaugment_config``,
  drawn from the step's generator); the compute dtype. A batch without
  ``src_frames`` or ``src_waveforms`` is a language model's (trainer.py:
  251-262): its tokens go to the criterion as they are;
* runs each microbatch of the batch's leading axis forward and backward in
  the compute dtype and sums its gradients in f32 (bf16 compute copies of
  the fp32 master weights, trainer.py:245-246: the gradient of the cast is
  the compute copy's gradient, widened);
* scales the summed gradients by ``1 / sample_size``, clips them to
  ``clip_norm`` by their global norm (``+1e-6``), and skips the update when
  the loss or the norm is not finite, bumping ``overflow_count``
  (trainer.py:316-347). The skip is chosen on the device (``torch.where``
  over the flat state), so a step never waits for the card;
* updates the batch-norm statistics in place whether or not the update is
  skipped, as JAX carries them;
* updates the EMA of the fp32 weights when ``optimization.ema_decay > 0``
  (trainer.py:349-381).

All weights live in one flat f32 buffer (``TrainState.params``); the
model's parameters are views of one flat buffer in the compute dtype (of the
master buffer itself in f32), and their gradients views of one flat
gradient buffer, so the optimizer, the norm and the cast are a few passes
over flat tensors. The host keeps the step count; the counts the optimizer
depends on (applied updates, overflows) stay on the device.

The valid step runs the model in eval mode (batch-norm running statistics,
no dropout) on the compute weights, or with ``optimization.ema_validate``
on a compute-dtype copy of the EMA weights, and returns the criterion's
sums on the device.

With ``task.scheduled_sampling`` a step takes the epoch's ``ss_prob``
(trainer.py:272-290) and hands it to the criterion; the speech LSTM draws
its coins from the step's generator.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from espresso_tpu_torch import bridge
from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.features.cmvn import GlobalCMVN
from espresso_tpu_torch.features.fbank_kernels import fbank_fused
from espresso_tpu_torch.features.specaugment import (
    SpecAugmentConfig,
    apply_specaugment,
    draw_specaugment,
)
from espresso_tpu_torch.features.transforms import delta_deltas
from espresso_tpu_torch.modules.dropout import set_dropout_generator
from espresso_tpu_torch.ops.quantization import QuantNoise
from espresso_tpu_torch.train.lr_schedulers import build_lr_schedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OptState:
    """An optimizer's state: its flat f32 slots (in the model's parameter
    order) and ``count``, the int32 count of applied updates on the device,
    which the lr schedule reads as optax's ``scale_by_schedule`` does."""

    def __init__(self, **tensors: torch.Tensor):
        self.__dict__.update(tensors)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return dict(self.__dict__)


@dataclass
class ParamBlock:
    """One parameter in the flat buffer: its offset and torch shape, its
    flax leaf name (``bridge.flax_leaves``: a kernel is held in the torch
    layout) and the first key of its flax path (the top-level name)."""

    offset: int
    shape: Tuple[int, ...]
    leaf: str
    top: str

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def param_blocks(model: nn.Module) -> List[ParamBlock]:
    """``model``'s parameters as blocks of its flat buffer, in parameter
    order."""
    leaves, (paths, _) = bridge.flax_leaves(model), bridge.flax_paths(model)
    out, off = [], 0
    for name, p in model.named_parameters():
        out.append(ParamBlock(off, tuple(p.shape), leaves[name], paths[name][0]))
        off += p.numel()
    return out


class Optimizer:
    """An optax chain of JAX's ``build_optimizer`` (trainer.py:43-87) on
    flat tensors: the named core transform (``direction``), then
    ``add_decayed_weights`` when ``weight_decay > 0`` (inside the core's
    chain for adamw, after it for the others: the same terms in the same
    order), then ``scale_by_schedule(-lr)``."""

    slots: Tuple[str, ...] = ()

    def __init__(self, weight_decay: float, schedule):
        self.weight_decay = weight_decay
        self.schedule = schedule

    def init(self, params: torch.Tensor, blocks: Optional[Sequence[ParamBlock]] = None) -> OptState:
        """The state of ``params``; ``blocks`` (``param_blocks``) names
        their parameters, for the optimizers that keep a state per
        parameter."""
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=params.device),
            **{name: torch.zeros_like(params) for name in self.slots},
        )

    def direction(
        self, g: torch.Tensor, state: OptState, count: torch.Tensor, params: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the core's update of ``g``, the new slots); ``count`` is the
        count of updates applied with this one."""
        raise NotImplementedError

    def update(
        self, g: torch.Tensor, state: OptState, params: torch.Tensor, count: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the chain's update, added to the weights; the new slots)."""
        upd, slots = self.direction(g, state, count, params)
        if self.weight_decay > 0.0:
            upd = upd + self.weight_decay * params
        return upd * -self.schedule(state.count), slots

    @torch.no_grad()
    def step(
        self, grads: torch.Tensor, state: OptState, params: torch.Tensor, apply: torch.Tensor
    ) -> None:
        """Update ``params`` and ``state`` in place where ``apply`` (a bool
        on the device) holds; leave both as they were where it does not."""
        g = torch.where(apply, grads, 0.0)  # a skipped step may hold NaN
        count = state.count + 1
        upd, slots = self.update(g, state, params, count)
        new_params = params + upd
        params.copy_(torch.where(apply, new_params, params))
        for name, value in slots.items():
            old = getattr(state, name)
            old.copy_(torch.where(apply, value, old))
        state.count.copy_(torch.where(apply, count, state.count))


def _bias_correction(moment: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
    return moment / (1 - torch.pow(decay, count.float()))


class Adam(Optimizer):
    """optax ``scale_by_adam``; ``adam`` and ``adamw`` (whose decay optax
    adds inside its chain, at the same point)."""

    slots = ("mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float, weight_decay: float, schedule):
        super().__init__(weight_decay, schedule)
        self.b1, self.b2, self.eps = b1, b2, eps

    def direction(self, g, state, count, params):
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        mu_hat = _bias_correction(mu, self.b1, count)
        nu_hat = _bias_correction(nu, self.b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps), {"mu": mu, "nu": nu}


class Adagrad(Optimizer):
    """optax ``scale_by_rss(initial_accumulator_value=0.0)``, eps 1e-7."""

    slots = ("sum_of_squares",)
    eps = 1e-7

    def direction(self, g, state, count, params):
        ss = g * g + state.sum_of_squares
        inv = torch.where(ss > 0, torch.rsqrt(ss + self.eps), 0.0)
        return inv * g, {"sum_of_squares": ss}


class Adadelta(Optimizer):
    """optax ``scale_by_adadelta()``: rho 0.9, eps 1e-6."""

    slots = ("e_g", "e_x")
    rho, eps = 0.9, 1e-6

    def direction(self, g, state, count, params):
        rho = self.rho
        e_g = (1 - rho) * (g * g) + rho * state.e_g
        upd = (torch.sqrt(state.e_x + self.eps) / torch.sqrt(e_g + self.eps)) * g
        e_x = (1 - rho) * (upd * upd) + rho * state.e_x
        return upd, {"e_g": e_g, "e_x": e_x}


class Adamax(Optimizer):
    """optax ``scale_by_adamax(b1, b2)``, eps 1e-8: the first moment's bias
    corrected over the infinity norm's decayed maximum."""

    slots = ("mu", "nu")
    eps = 1e-8

    def __init__(self, b1: float, b2: float, weight_decay: float, schedule):
        super().__init__(weight_decay, schedule)
        self.b1, self.b2 = b1, b2

    def direction(self, g, state, count, params):
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = torch.maximum(g.abs() + self.eps, self.b2 * state.nu)
        return _bias_correction(mu, self.b1, count) / nu, {"mu": mu, "nu": nu}


class SGD(Optimizer):
    """``optax.identity()``: the gradient itself."""

    def direction(self, g, state, count, params):
        return g, {}


class Momentum(Optimizer):
    """optax ``trace(decay=momentum, nesterov)``: ``momentum`` and ``nag``."""

    slots = ("trace",)

    def __init__(self, decay: float, nesterov: bool, weight_decay: float, schedule):
        super().__init__(weight_decay, schedule)
        self.decay, self.nesterov = decay, nesterov

    def direction(self, g, state, count, params):
        trace = g + self.decay * state.trace
        return (g + self.decay * trace) if self.nesterov else trace, {"trace": trace}


class Adafactor(Optimizer):
    """``optax.adafactor(learning_rate=None)`` (optax 0.2.6), per parameter
    in its flax layout (``bridge.to_flax_layout``: a kernel [in, out], a
    convolution's [kh, kw, in, out]), so that the row and column statistics
    are the ones JAX keeps: ``scale_by_factored_rms`` (decay 1 - t^-0.8,
    eps 1e-30; factored over the two largest dims when the smaller of them
    is at least 128, else a full second moment), ``clip_by_block_rms(1)``,
    ``scale_by_param_block_rms(1e-3)`` and ``scale(-1)``. JAX's
    ``build_optimizer`` then appends ``scale_by_schedule(-lr)``, as for every
    optimizer, so the chain's sign flips twice and the update climbs the
    gradient: the port computes what JAX computes (ROADMAP queue C,
    reference faults). The slots ``v_row``, ``v_col`` and ``v`` hold each
    parameter's statistics flat, in parameter order."""

    slots = ("v_row", "v_col", "v")
    decay_rate, eps, min_dim_size_to_factor, clip, min_scale = 0.8, 1e-30, 128, 1.0, 1e-3

    def init(self, params, blocks=None):
        if blocks is None:
            raise ValueError("adafactor keeps statistics per parameter: init needs its parameter blocks")
        # per block: (block, factored dims (d1, d0) or None, and the (slice,
        # shape) of its v_row and v_col, or of its v, in their slots)
        self.plan = []
        sizes = dict.fromkeys(self.slots, 0)
        for blk in blocks:
            shape = tuple(bridge.to_flax_layout(blk.leaf, torch.empty(blk.shape, device="meta")).shape)
            dims = self._factored_dims(shape)
            if dims is None:
                parts = {"v": shape}
            else:
                d1, d0 = dims
                parts = {"v_row": tuple(np.delete(shape, d0)), "v_col": tuple(np.delete(shape, d1))}
            where = {}
            for slot, sh in parts.items():
                n = int(np.prod(sh, dtype=np.int64))
                where[slot] = (slice(sizes[slot], sizes[slot] + n), sh)
                sizes[slot] += n
            self.plan.append((blk, dims, where))
        dev = params.device
        return OptState(count=torch.zeros((), dtype=torch.int32, device=dev),
                        **{k: torch.zeros(n, device=dev) for k, n in sizes.items()})

    def _factored_dims(self, shape):
        """optax's ``_factored_dims``: the two largest dims (argsort's
        order), when the smaller is at least ``min_dim_size_to_factor``."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def direction(self, g, state, count, params):
        decay = 1.0 - torch.pow(count.float(), -self.decay_rate)
        upd = torch.empty_like(g)
        new = {k: getattr(state, k).clone() for k in self.slots}
        for blk, dims, where in self.plan:
            o, n = blk.offset, blk.numel
            grad = bridge.to_flax_layout(blk.leaf, g[o : o + n].view(blk.shape))
            gsq = grad * grad + self.eps
            old = {k: getattr(state, k)[sl].view(sh) for k, (sl, sh) in where.items()}
            if dims is None:
                stats = {"v": decay * old["v"] + (1.0 - decay) * gsq}
                u = grad * stats["v"] ** -0.5
            else:
                d1, d0 = dims
                v_row = decay * old["v_row"] + (1.0 - decay) * gsq.mean(d0)
                v_col = decay * old["v_col"] + (1.0 - decay) * gsq.mean(d1)
                stats = {"v_row": v_row, "v_col": v_col}
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
                u = grad * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            for k, v in stats.items():
                new[k][where[k][0]] = v.reshape(-1)
            # clip_by_block_rms(1), scale_by_param_block_rms(1e-3), scale(-1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.clip, min=1.0)
            p = params[o : o + n]
            rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(rms <= self.min_scale, self.min_scale, rms)
            upd[o : o + n] = bridge.from_flax_layout(blk.leaf, u * -1.0).reshape(-1)
        return upd, new


class Composite(Optimizer):
    """JAX's ``_build_composite`` (trainer.py:90-132, ``optax.multi_transform``):
    each group names a sub-optimizer (built as ``build_optimizer`` builds
    one, its own decay and schedule included) and an optional ``lr_scale``
    applied after it; a parameter goes to the group whose name is the
    longest prefix of its top-level flax name, else to ``default`` (adam
    unless given). A group's slots are saved as ``<group>.<slot>``; one
    count serves every group (each sub-chain's count is the same)."""

    def __init__(self, groups: Dict[str, Tuple[Optimizer, float]]):
        super().__init__(0.0, None)
        self.groups = groups
        self.prefixes = sorted((g for g in groups if g != "default"), key=len, reverse=True)

    def label_of(self, top: str) -> str:
        return next((p for p in self.prefixes if top.startswith(p)), "default")

    def init(self, params, blocks=None):
        if blocks is None:
            raise ValueError("composite assigns parameters by name: init needs its parameter blocks")
        dev = params.device
        self.index = {}
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        for name, (opt, _) in self.groups.items():
            mine, sub, off = [], [], 0
            for blk in blocks:
                if self.label_of(blk.top) == name:
                    mine.append(torch.arange(blk.offset, blk.offset + blk.numel, device=dev))
                    sub.append(dataclasses.replace(blk, offset=off))
                    off += blk.numel
            idx = torch.cat(mine) if mine else torch.zeros(0, dtype=torch.long, device=dev)
            self.index[name] = idx
            for slot, t in opt.init(params[idx], sub).tensors().items():
                if slot != "count":
                    state[f"{name}.{slot}"] = t
        return OptState(**state)

    def update(self, g, state, params, count):
        upd = torch.empty_like(params)
        slots = {}
        for name, (opt, scale) in self.groups.items():
            idx = self.index[name]
            sub = OptState(count=state.count, **{k: getattr(state, f"{name}.{k}") for k in opt.slots})
            u, new = opt.update(g[idx], sub, params[idx], count)
            if scale != 1.0:
                u = u * scale
            upd.index_copy_(0, idx, u)
            slots.update({f"{name}.{k}": v for k, v in new.items()})
        return upd, slots


def _build_composite(cfg: EspressoConfig, schedule) -> Composite:
    if not cfg.optimizer.groups:
        raise ValueError("optimizer.name=composite needs optimizer.groups")
    groups = dict(cfg.optimizer.groups)
    groups.setdefault("default", {"name": "adam"})
    built = {}
    for name, spec in groups.items():
        sub = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, groups=None))
        for k, v in dict(spec).items():
            if k != "lr_scale":
                setattr(sub.optimizer, k, tuple(v) if isinstance(v, list) else v)
        built[name] = (build_optimizer(sub)[0], float(dict(spec).get("lr_scale", 1.0)))
    return Composite(built)


def build_optimizer(cfg: EspressoConfig) -> Tuple[Optimizer, Callable]:
    """(optimizer, lr schedule) for ``cfg.optimizer.name``: adam, adamw,
    adafactor, adagrad, adadelta, adamax, sgd, nag, momentum or
    composite."""
    schedule = build_lr_schedule(cfg.lr_scheduler, cfg.optimization)
    ocfg = cfg.optimizer
    name, wd = ocfg.name, ocfg.weight_decay
    b1, b2 = ocfg.adam_betas
    if name in ("adam", "adamw"):
        opt = Adam(b1, b2, ocfg.adam_eps, wd, schedule)
    elif name == "adagrad":
        opt = Adagrad(wd, schedule)
    elif name == "adadelta":
        opt = Adadelta(wd, schedule)
    elif name == "adamax":
        opt = Adamax(b1, b2, wd, schedule)
    elif name == "sgd":
        opt = SGD(wd, schedule)
    elif name in ("nag", "momentum"):
        opt = Momentum(ocfg.momentum, name == "nag", wd, schedule)
    elif name == "adafactor":
        opt = Adafactor(wd, schedule)
    elif name == "composite":
        return _build_composite(cfg, schedule), schedule
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, schedule


@dataclass
class TrainState:
    step: int  # train_step calls so far (skipped ones included)
    params: torch.Tensor  # flat f32 master weights
    opt_state: OptState
    compute: torch.Tensor  # flat weights in the compute dtype (the model's)
    grads: torch.Tensor  # flat gradients of the compute weights
    ema_params: Optional[torch.Tensor] = None  # flat f32
    overflow_count: Optional[torch.Tensor] = None  # int32 on the device


def _flatten_into(model: nn.Module, flat: torch.Tensor, grads: torch.Tensor) -> None:
    """Make every parameter of ``model`` a view of ``flat`` and its gradient
    a view of ``grads`` (autograd then accumulates into the views)."""
    off = 0
    for p in model.parameters():
        n = p.numel()
        p.data = flat[off : off + n].view_as(p)
        p.grad = grads[off : off + n].view_as(p)
        off += n


@torch.no_grad()
def create_train_state(model: nn.Module, optimizer: Optimizer, cfg: EspressoConfig) -> TrainState:
    """The train state of ``model``'s current weights (a seeded init, or
    weights carried across by ``bridge.load_jax_variables``), on the
    model's device, with an EMA copy when ``optimization.ema_decay > 0``.
    The model's parameters become views of the state's compute buffer (the
    master buffer itself in f32; a step with quant noise gives such a state
    a compute buffer of its own); its batch-norm statistics stay f32
    buffers of the model, updated in place by each step."""
    dtype = _DTYPES[cfg.common.dtype]
    params = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
    compute = params.to(dtype) if dtype != torch.float32 else params
    grads = torch.zeros_like(compute)
    _flatten_into(model, compute, grads)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params, param_blocks(model)),
        compute=compute,
        grads=grads,
        ema_params=params.clone() if cfg.optimization.ema_decay > 0.0 else None,
        overflow_count=torch.zeros((), dtype=torch.int32, device=params.device),
    )


def make_device_feature_fn(cfg: EspressoConfig):
    """On-device fbank for waveform batches (``fbank_fused``), then global
    CMVN and delta-deltas. Returns ``prepare(mb) -> mb``: a batch with
    ``src_waveforms`` [B, S] and ``num_samples`` [B] gets ``src_frames``
    [B, T, F] f32 and ``src_lengths`` [B] int32 in their place, on the
    batch's device, without a host sync; with ``feature_type ==
    "waveform"`` the samples pass through as frames; a batch of frames is
    returned as it is. The CMVN stats are read from their ``.npz`` here and
    copied to the batches' device at the first batch."""
    feat_dim = cfg.dataset.feat_dim
    sample_rate = float(cfg.dataset.sample_rate)
    path = cfg.dataset.global_cmvn_stats_path
    cmvn = GlobalCMVN(path) if path else None

    @torch.no_grad()
    def prepare(mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "src_waveforms" not in mb:
            return mb
        out = dict(mb)
        waveforms, num_samples = out.pop("src_waveforms"), out.pop("num_samples")
        if cfg.dataset.feature_type == "waveform":
            # raw-waveform models: the samples are the frames
            out["src_frames"], out["src_lengths"] = waveforms, num_samples
            return out
        frames, lengths = fbank_fused(
            waveforms, num_samples, sample_rate=sample_rate, num_mel_bins=feat_dim
        )
        if cmvn is not None:
            if cmvn.mean.device != frames.device:
                cmvn.to(frames.device)
            frames = cmvn(frames)
        if cfg.dataset.delta_deltas:
            frames = delta_deltas(frames)
        out["src_frames"], out["src_lengths"] = frames, lengths
        return out

    return prepare


def make_train_step(model: nn.Module, criterion, optimizer: Optimizer, cfg: EspressoConfig):
    """Returns ``train_step(state, batch, generator=None, ss_prob=None) ->
    (state, metrics)``. ``batch`` tensors have a leading microbatch axis
    [n_micro, B, ...] (1 for no accumulation); ``generator`` (a
    ``torch.Generator`` on the model's device) drives every dropout of the
    step. The metrics are tensors on the device: reading one is the
    caller's choice of host sync. The same generator draws SpecAugment's
    random numbers, the quant-noise masks and the scheduled-sampling coins;
    ``ss_prob`` is the teacher-forcing rate, read where
    ``task.scheduled_sampling`` is set (1.0 otherwise)."""
    compute_dtype = _DTYPES[cfg.common.dtype]
    prepare_features = make_device_feature_fn(cfg)
    specaug = (
        SpecAugmentConfig.from_string(cfg.dataset.specaugment_config)
        if cfg.dataset.specaugment_config
        else None
    )
    qn_p = cfg.optimization.quant_noise_pq
    quant_noise = (
        QuantNoise(model, qn_p, cfg.optimization.quant_noise_block_size) if qn_p > 0.0 else None
    )
    clip_norm = cfg.optimization.clip_norm
    ema_decay = cfg.optimization.ema_decay
    ema_start_update = cfg.optimization.ema_start_update
    ema_update_freq = max(cfg.optimization.ema_update_freq, 1)
    use_ss = cfg.task.scheduled_sampling

    def train_step(
        state: TrainState, batch: Dict[str, torch.Tensor], generator=None, ss_prob=None
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        ss = float(ss_prob) if use_ss and ss_prob is not None else 1.0
        extra = {"ss_prob": ss} if ss < 1.0 else {}
        model.train()
        set_dropout_generator(model, generator)
        dev = state.params.device
        if quant_noise is not None and state.compute is state.params:
            # f32: the model's weights are the masters themselves; the noise
            # needs a compute buffer of its own, never the masters
            state.compute = state.params.clone()
            _flatten_into(model, state.compute, state.grads)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        grads = torch.zeros_like(state.params)
        loss_sum, size_sum = zero(), zero()
        logs = {k: zero() for k in criterion.logging_keys}
        for i in range(batch["prev_output_tokens"].shape[0]):
            mb = {k: v[i] for k, v in batch.items()}
            if quant_noise is not None:
                # noise the masters, then cast (trainer.py:234-246); the
                # update below writes the compute copies anew from the masters
                keep = quant_noise.mask(quant_noise.draw(generator))
                with torch.no_grad():
                    state.compute.copy_(quant_noise.apply(state.params, keep))
            mb = prepare_features(mb)
            if "src_frames" in mb:  # else a language-model batch (trainer.py:251)
                frames = mb["src_frames"].float()
                if specaug is not None:
                    draws = draw_specaugment(frames.shape[0], frames.shape[-1], specaug, generator, dev)
                    frames = apply_specaugment(frames, mb["src_lengths"], draws, specaug)
                mb["src_frames"] = frames.to(compute_dtype)
            state.grads.zero_()
            loss, sample_size, logging = criterion(model, mb, **extra)
            loss.backward()
            g = state.grads.float()
            grads += g if quant_noise is None else quant_noise.apply(g, keep)
            loss_sum += loss.detach().float()
            size_sum += sample_size.detach().float()
            for k in logs:
                logs[k] += logging[k].detach().float()

        with torch.no_grad():
            grads *= torch.where(size_sum > 0, 1.0 / size_sum, 0.0)
            # a sum of squares, not vector_norm: the CPU norm kernel of a long
            # f32 vector loses ~1e-4 of precision, the sum is cascaded
            gnorm = torch.sqrt((grads * grads).sum())
            if clip_norm > 0:
                grads *= torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0)
            finite = torch.isfinite(gnorm) & torch.isfinite(loss_sum)
            optimizer.step(grads, state.opt_state, state.params, finite)
            if state.compute is not state.params:
                state.compute.copy_(state.params)  # the new compute copies
            if ema_decay > 0.0 and state.ema_params is not None:
                # decay 0 before ema_start_update (the EMA copies the params);
                # every ema_update_freq-th update; never on a skipped one
                decay = ema_decay if state.step >= ema_start_update else 0.0
                if (state.step + 1) % ema_update_freq == 0:
                    ema = state.ema_params * decay + state.params * (1.0 - decay)
                    state.ema_params.copy_(torch.where(finite, ema, state.ema_params))
            state.overflow_count += (~finite).to(torch.int32)
        state.step += 1
        metrics = {
            "loss": loss_sum,
            "sample_size": size_sum,
            "gnorm": gnorm,
            "overflow": (~finite).float(),
            **logs,
        }
        return state, metrics

    return train_step


def make_valid_step(model: nn.Module, criterion, cfg: EspressoConfig):
    """Returns ``valid_step(state, batch) -> {"loss", "sample_size",
    **logging}``, tensors on the device (no host sync). ``batch`` is one
    microbatch (no leading axis), frames or waveforms. The model runs in
    eval mode; its frames are cast to the compute dtype (trainer.py:
    402-432). With ``optimization.ema_validate`` (and ``ema_decay > 0``) the
    model's parameters point for the call at a compute-dtype copy of
    ``state.ema_params`` and back at ``state.compute`` after it; the fp32
    masters are never touched."""
    compute_dtype = _DTYPES[cfg.common.dtype]
    use_ema = cfg.optimization.ema_validate and cfg.optimization.ema_decay > 0.0
    prepare_features = make_device_feature_fn(cfg)

    @torch.no_grad()
    def valid_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        ema = use_ema and state.ema_params is not None
        if ema:
            # the EMA weights themselves in f32, a compute-dtype copy else
            _flatten_into(model, state.ema_params.to(compute_dtype), state.grads)
        try:
            mb = prepare_features(dict(batch))
            if "src_frames" in mb:
                mb["src_frames"] = mb["src_frames"].to(compute_dtype)
            loss, sample_size, logging = criterion(model, mb)
        finally:
            if ema:
                _flatten_into(model, state.compute, state.grads)
        return {"loss": loss, "sample_size": sample_size, **logging}

    return valid_step
