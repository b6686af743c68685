"""The train step: microbatch accumulation, clip, overflow skip, adam, EMA.

Counterpart of ``espresso_tpu/train/trainer.py``: ``build_optimizer`` for
``adam`` (trainer.py:43-87), ``make_train_step`` (:192-399) and
``create_train_state`` (:435-461). One step:

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

Not ported: SpecAugment, quant-noise, scheduled sampling, on-device fbank,
the other optimizers and the composite optimizer, ``make_valid_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.config import EspressoConfig
from espresso_tpu_torch.modules.dropout import set_dropout_generator
from espresso_tpu_torch.train.lr_schedulers import build_lr_schedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class AdamState:
    mu: torch.Tensor  # flat f32 first moment
    nu: torch.Tensor  # flat f32 second moment
    count: torch.Tensor  # int32 on the device: updates applied so far


class Adam:
    """optax ``scale_by_adam`` -> ``add_decayed_weights`` (after adam, when
    ``weight_decay > 0``) -> ``scale_by_schedule(-lr)``, on flat tensors.
    The schedule reads the count of applied updates, as optax's does."""

    def __init__(self, b1: float, b2: float, eps: float, weight_decay: float, schedule):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.schedule = schedule

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(
            torch.zeros_like(params),
            torch.zeros_like(params),
            torch.zeros((), dtype=torch.int32, device=params.device),
        )

    @torch.no_grad()
    def step(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor, apply: torch.Tensor
    ) -> None:
        """Update ``params`` and ``state`` in place where ``apply`` (a bool
        on the device) holds; leave both as they were where it does not."""
        b1, b2 = self.b1, self.b2
        g = torch.where(apply, grads, 0.0)  # a skipped step may hold NaN
        mu = (1 - b1) * g + b1 * state.mu
        nu = (1 - b2) * (g * g) + b2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1 - torch.pow(b1, count.float()))
        nu_hat = nu / (1 - torch.pow(b2, count.float()))
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay > 0.0:
            upd = upd + self.weight_decay * params
        new_params = params + upd * -self.schedule(state.count)
        params.copy_(torch.where(apply, new_params, params))
        state.mu.copy_(torch.where(apply, mu, state.mu))
        state.nu.copy_(torch.where(apply, nu, state.nu))
        state.count.copy_(torch.where(apply, count, state.count))


def build_optimizer(cfg: EspressoConfig) -> Tuple[Adam, Callable]:
    """(optimizer, lr schedule) for ``optimizer.name == "adam"``."""
    schedule = build_lr_schedule(cfg.lr_scheduler, cfg.optimization)
    if cfg.optimizer.name != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer.name!r}")
    b1, b2 = cfg.optimizer.adam_betas
    return Adam(b1, b2, cfg.optimizer.adam_eps, cfg.optimizer.weight_decay, schedule), schedule


@dataclass
class TrainState:
    step: int  # train_step calls so far (skipped ones included)
    params: torch.Tensor  # flat f32 master weights
    opt_state: AdamState
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
def create_train_state(model: nn.Module, optimizer: Adam, cfg: EspressoConfig) -> TrainState:
    """The train state of ``model``'s current weights (a seeded init, or
    weights carried across by ``bridge.load_jax_variables``), on the
    model's device, with an EMA copy when ``optimization.ema_decay > 0``.
    The model's parameters become views of the state's compute buffer; its
    batch-norm statistics stay f32 buffers of the model, updated in place by
    each step."""
    dtype = _DTYPES[cfg.common.dtype]
    params = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
    compute = params if dtype == torch.float32 else params.to(dtype)
    grads = torch.zeros_like(compute)
    _flatten_into(model, compute, grads)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        compute=compute,
        grads=grads,
        ema_params=params.clone() if cfg.optimization.ema_decay > 0.0 else None,
        overflow_count=torch.zeros((), dtype=torch.int32, device=params.device),
    )


def make_train_step(model: nn.Module, criterion, optimizer: Adam, cfg: EspressoConfig):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``. ``batch`` tensors have a leading microbatch axis
    [n_micro, B, ...] (1 for no accumulation); ``generator`` (a
    ``torch.Generator`` on the model's device) drives every dropout of the
    step. The metrics are tensors on the device: reading one is the
    caller's choice of host sync."""
    compute_dtype = _DTYPES[cfg.common.dtype]
    clip_norm = cfg.optimization.clip_norm
    ema_decay = cfg.optimization.ema_decay
    ema_start_update = cfg.optimization.ema_start_update
    ema_update_freq = max(cfg.optimization.ema_update_freq, 1)

    def train_step(
        state: TrainState, batch: Dict[str, torch.Tensor], generator=None
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        set_dropout_generator(model, generator)
        dev = state.params.device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        grads = torch.zeros_like(state.params)
        loss_sum, size_sum = zero(), zero()
        logs = {k: zero() for k in criterion.logging_keys}
        for i in range(batch["prev_output_tokens"].shape[0]):
            mb = {k: v[i] for k, v in batch.items()}
            mb["src_frames"] = mb["src_frames"].float().to(compute_dtype)
            state.grads.zero_()
            loss, sample_size, logging = criterion(model, mb)
            loss.backward()
            grads += state.grads.float()
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
