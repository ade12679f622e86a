"""The training step on one card.

Counterpart of ``blurr_tpu/parallel/train.py:make_optax_train_step`` (and
of the fixture ``make_train_step``, plain SGD), and of the jitted steps of
``scripts/train_openvla_lora.py``. JAX jits one function of (params,
opt_state, batch, key); here the step is a closure over the model and its
optimizer that updates them in place:

    batch floats cast to the compute dtype -> the loss on (batch, *extra)
    -> gradients of the trainable parameters -> [accumulate k] -> AdamW
    (clip inside) -> [EMA]

The loss is a callable ``loss_fn(model, *inputs, remat=)`` whose inputs
are the batch's ``batch_keys`` in order, then the step's extra arguments:
Pi-0's flow loss (the default, ``flow_loss`` on ``_BATCH_KEYS`` and the
step's noise and t), OpenVLA's ``action_ce_loss`` or ``oft_l1_loss``
(``scripts/train_openvla_lora_torch.py``).

``compute_dtype`` (master-fp32) keeps the parameters, the moments and the
gradients in their own (fp32) dtype while the forward and backward run on
cast copies, ``torch.func.functional_call`` over
``utils/optim.py:cast_params`` (the quant scales and ``lora_s`` stay fp32,
as JAX's ``cast_floating_preserving_scales``; ``autocast`` would cast
per operation instead). The step takes its noise and flow time
explicitly; ``sample_noise_and_t`` draws them from a ``torch.Generator``
(normal noise, t ~ Beta(1.5, 1) as ``u ** (2/3)``), where JAX draws
``normal(k1)`` and ``beta(k2, 1.5, 1)`` from the step's key. The mesh of
ranks and the TP layers are ported for serving (``parallel/mesh.py``,
``parallel/tensor_parallel.py``); training over them (the step's mesh,
``donate``, ``pipeline`` and ``sp_axis``) is M14's training half, ROADMAP
Queue 1 item 6b.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from blurr_tpu_torch.utils.optim import AdamW, GradAccumulator, ParamsEMA, cast_params

_BATCH_KEYS = ("input_ids", "attention_mask", "pixel_values", "proprios", "actions")


def param_dtype(model: nn.Module) -> torch.dtype:
    """The dtype of the model's first floating parameter."""
    return next(p.dtype for p in model.parameters() if p.is_floating_point())


def cast_batch(batch: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating batch entries to ``dtype``; the int ids and mask as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def sample_noise_and_t(generator: torch.Generator, actions: torch.Tensor):
    """(noise fp32 [B, H, A] ~ N(0, 1), t fp32 [B] ~ Beta(1.5, 1)) on the
    generator's device. Beta(1.5, 1) has the CDF t ** 1.5, so ``u ** (2/3)``
    of a uniform u is exactly that law."""
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    noise = torch.randn(tuple(actions.shape), **kw)
    t = torch.rand(actions.shape[0], **kw) ** (2.0 / 3.0)
    return noise, t


def flow_loss(model: nn.Module, input_ids, attention_mask, pixel_values, proprios, actions,
              noise, t, remat: bool = False) -> torch.Tensor:
    """Pi-0's loss on ``_BATCH_KEYS`` and the step's (noise, t)."""
    return model.flow_loss(input_ids, attention_mask, pixel_values, proprios, actions, t, noise,
                           remat=remat)


class _LossAndGrads(nn.Module):
    """The loss and the gradients of ``wrt``, computed inside one call so
    that ``torch.func.functional_call`` keeps the cast copies in place for
    the backward too (``remat`` recomputes layers there)."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, args, remat: bool, wrt):
        loss = self.loss_fn(self.model, *args, remat=remat)
        return loss, torch.autograd.grad(loss, wrt, allow_unused=True)


def make_train_step(model: nn.Module, optimizer: AdamW, remat: bool = False,
                    compute_dtype: Optional[torch.dtype] = None, accum_steps: int = 1,
                    ema: Optional[ParamsEMA] = None, loss_fn: Callable = flow_loss,
                    batch_keys: Sequence[str] = _BATCH_KEYS):
    """``step(batch, *extra) -> loss`` (a 0-d fp32 tensor, left on the
    device): one micro-batch's ``loss_fn(model, *batch[batch_keys],
    *extra, remat=remat)`` and the gradients of ``optimizer.params``
    (Pi-0's default: ``step(batch, noise, t)``); with ``accum_steps`` k > 1
    the parameters update on every k-th call with the mean of the k
    gradients (``GradAccumulator``, ``optax.MultiSteps``), and the EMA
    follows each update. ``step.accumulator`` holds the accumulator (None
    for k = 1)."""
    trainable = optimizer.params
    acc = GradAccumulator(trainable, accum_steps) if accum_steps > 1 else None
    holder = _LossAndGrads(model, loss_fn)
    keys = tuple(batch_keys)

    def step(batch: Dict[str, torch.Tensor], *extra: torch.Tensor):
        batch = cast_batch(batch, compute_dtype or param_dtype(model))
        args = tuple(batch[k] for k in keys) + extra
        if compute_dtype is None:
            loss, grads = holder(args, remat, trainable)
        else:
            params = {f"model.{k}": v for k, v in cast_params(model, compute_dtype).items()}
            # each module once: setting the action mixture's tensors sets the
            # tied proprio module's, and each is restored once after the call
            loss, grads = torch.func.functional_call(holder, params, (args, remat, trainable),
                                                     tie_weights=False)
        grads = list(grads)
        if acc is not None:
            grads = acc.add(grads)
            if grads is None:
                return loss.detach()
        optimizer.step(grads)
        if ema is not None:
            ema.update()
        return loss.detach()

    step.accumulator = acc
    return step
