"""Training-side optimizer utilities: the schedules, the AdamW step over the
trainable parameters, gradient accumulation, the EMA and the casts.

Counterpart of ``blurr_tpu/utils/optim.py`` and of the optax pieces the JAX
trainer chains (``scripts/train_pi0_flow.py``):

- ``cosine_annealing_warmup_restarts``: the host schedule JAX logs.
- ``warmup_cosine_decay_schedule``: optax's, the one the JAX optimizer
  steps (linear warmup, then cosine decay to ``end_value``), computed in
  fp32 with optax's operations in optax's order.
- ``AdamW``: ``masked_freeze(chain(clip_by_global_norm, adamw(schedule)),
  mask)``. Frozen parameters are not handed to it at all (their
  ``requires_grad`` is off, ``models/pi0/trainable.py``), so they get no
  update and no weight decay, and the clip's global norm is over the
  trainable gradients only. The moments take each parameter's dtype, as
  optax's do; the update is optax's ``scale_by_adam`` ->
  ``add_decayed_weights`` -> ``scale_by_learning_rate`` -> ``apply_updates``.
  Over a mesh of ranks the clip's norm sums each leaf's squares over the
  axes it is split on.
- ``GradAccumulator``: ``optax.MultiSteps`` (the running mean of k
  micro-gradients, one real update every k-th call).
- ``ParamsEMA`` / ``extract_ema``: ``params_ema`` / ``extract_ema`` with
  the trainable mask: a bias-corrected EMA of the post-update trainable
  parameters; frozen ones are taken from the live model.
- ``cast_floating_preserving_scales``, ``cast_params``,
  ``get_num_params_in_billions``.

``value_and_grad_frozen_int`` has no counterpart: the int payloads of the
quantized linears are buffers, not parameters, so autograd never asks for
their gradient.
"""

from __future__ import annotations

import itertools

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from blurr_tpu_torch.ops.quant import QUANTIZED_LINEARS


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    max_lr: float = 0.1,
    min_lr: float = 0.001,
    warmup_steps: int = 0,
    gamma: float = 1.0,
):
    """Schedule step -> lr: linear warmup, then cosine cycles whose length
    multiplies by ``cycle_mult`` and whose peak decays by ``gamma`` per
    cycle (the reference's CosineAnnealingWarmupRestarts). Host floats."""
    assert warmup_steps < first_cycle_steps

    def schedule(step):
        step = float(step)
        cycle = 0
        cycle_steps = first_cycle_steps
        step_in_cycle = step
        while step_in_cycle >= cycle_steps:
            step_in_cycle -= cycle_steps
            cycle += 1
            cycle_steps = cycle_steps * cycle_mult
        peak = max_lr * (gamma**cycle)
        if step_in_cycle < warmup_steps:
            return (peak - min_lr) * step_in_cycle / warmup_steps + min_lr
        progress = (step_in_cycle - warmup_steps) / (cycle_steps - warmup_steps)
        return min_lr + (peak - min_lr) * (1 + math.cos(math.pi * progress)) / 2

    return schedule


_LIBM = []


def _cosf(x: np.float32) -> np.float32:
    """cos in fp32 as the C library's ``cosf`` gives it: what XLA on the
    CPU computes for a scalar ``jnp.cos``, so the schedule's values match
    optax's to the bit (a float64 cos rounded to fp32 differs in the last
    bit at a few counts). Without a C math library: that rounding."""
    if not _LIBM:
        import ctypes
        import ctypes.util

        name = ctypes.util.find_library("m")
        lib = ctypes.CDLL(name) if name else None
        if lib is not None:
            lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
        _LIBM.append(lib)
    lib = _LIBM[0]
    return np.float32(lib.cosf(float(x)) if lib is not None else math.cos(float(x)))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0):
    """optax's ``warmup_cosine_decay_schedule``: count -> an fp32 value.
    ``linear_schedule(init, peak, warmup)`` before ``warmup_steps``, then
    ``cosine_decay_schedule(peak, decay_steps - warmup_steps, end/peak)``;
    count 0 gives ``init_value`` (to its fp32 rounding). Each operation
    rounds to fp32 where optax's does (its Python constants enter as fp32),
    the cosine included (``_cosf``)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got {cos_steps}")

    def warmup(count: int):
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int):
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + _cosf(f32(np.pi) * c / f32(cos_steps)))
        if exponent != 1.0:
            decay = decay ** f32(exponent)
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> float:
        count = int(count)
        out = warmup(count) if count < warmup_steps else cosine(count - warmup_steps)
        return float(f32(out))

    return schedule


def _global_norm(grads: Iterable[torch.Tensor], mesh=None,
                 split: Optional[List[Tuple[bool, ...]]] = None) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum of every squared element (fp32).
    Over a ``mesh`` of ranks, ``split[i]`` says whether gradient i is the
    rank's slice over the model ranks, over the data ranks and (a third
    entry, on a pipeline mesh) over the pipe ranks (a staged layer's): a
    leaf's squares are summed over each axis it is split on, so a
    replicated leaf counts once and a sharded one by its shards (every rank
    gets the same norm)."""
    sq = [(g.float() ** 2).sum() for g in grads]
    if mesh is None or split is None:
        return torch.sqrt(sum(sq))
    from blurr_tpu_torch.parallel.mesh import all_reduce_sum

    axes = len(split[0]) if split else 2
    groups = (mesh.model_group, mesh.data_group, mesh.pipe_group)[:axes]
    zero = sq[0].new_zeros(()) if sq else torch.zeros(())
    keys = list(itertools.product((False, True), repeat=axes))
    part = torch.stack([sum((x for x, k in zip(sq, split) if tuple(k) == key), zero)
                        for key in keys])
    for a, group in enumerate(groups):  # each key's sum over the axes it is split on
        rows = [i for i, key in enumerate(keys) if key[a]]
        part = part.index_put((torch.tensor(rows, device=part.device),),
                              all_reduce_sum(part[rows], group))
    return torch.sqrt(part.sum())


class AdamW:
    """optax ``adamw(schedule)`` with its defaults (b1 0.9, b2 0.999, eps
    1e-8, weight_decay 1e-4), preceded by ``clip_by_global_norm(grad_clip)``
    when ``grad_clip`` > 0, over ``params`` (the trainable ones only).
    ``step(grads)`` updates the parameters in place from one gradient each
    (None counts as zero). ``count`` is the number of updates made; the
    learning rate of an update is ``schedule(count)`` before it. Over a
    ``mesh`` of ranks the parameters are the rank's shards (the moments are
    too) and ``split`` says which axes each is split on, for the clip's
    global norm (``_global_norm``)."""

    def __init__(self, params: Iterable[nn.Parameter], schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 grad_clip: float = 0.0, mesh=None,
                 split: Optional[List[Tuple[bool, bool]]] = None):
        self.params: List[nn.Parameter] = list(params)
        self.mesh, self.split = mesh, split
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.grad_clip = float(grad_clip)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> None:
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self.grad_clip > 0:
            norm = _global_norm(grads, self.mesh, self.split)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip)
                     for g in grads]
        count = self.count + 1
        f32 = torch.float32
        # optax's scalars: the bias corrections and the step size in fp32,
        # each cast to the moment's or the update's dtype
        scalars = {
            "bc1": 1 - torch.tensor(self.b1, dtype=f32) ** count,
            "bc2": 1 - torch.tensor(self.b2, dtype=f32) ** count,
            "lr": torch.tensor(-self.schedule(self.count), dtype=f32),
        }
        cast = {}

        def scalar(name, like):
            key = (name, like.device, like.dtype)
            if key not in cast:
                cast[key] = scalars[name].to(like.device, like.dtype)
            return cast[key]

        b1, b2 = self.b1, self.b2
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - b1) * g + b1 * self.mu[i]
            nu = (1 - b2) * g**2 + b2 * self.nu[i]
            u = (mu / scalar("bc1", mu)) / (torch.sqrt(nu / scalar("bc2", nu)) + self.eps)
            u = u + self.weight_decay * p
            u = scalar("lr", u) * u
            p.copy_((p + u).to(p.dtype))
            self.mu[i], self.nu[i] = mu, nu
        self.count = count

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for t, src in zip(mine, theirs, strict=True):
                t.copy_(src)


class GradAccumulator:
    """``optax.MultiSteps(tx, k)``: ``add(grads)`` folds one micro-step's
    gradients into the running mean ``acc + (g - acc) / (n + 1)`` and
    returns the mean on every k-th call (then starts over), else None."""

    def __init__(self, params: Iterable[nn.Parameter], k: int):
        self.k = int(k)
        self.acc = [torch.zeros_like(p) for p in params]
        self.mini_step = 0

    @torch.no_grad()
    def add(self, grads: List[Optional[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
        n = self.mini_step
        for i, g in enumerate(grads):
            g = torch.zeros_like(self.acc[i]) if g is None else g
            self.acc[i] = self.acc[i] + (g - self.acc[i]) / (n + 1)
        self.mini_step = (n + 1) % self.k
        if self.mini_step:
            return None
        out = self.acc
        self.acc = [torch.zeros_like(a) for a in out]
        return out

    def state_dict(self) -> Dict:
        return {"mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: Dict) -> None:
        self.mini_step = int(state["mini_step"])
        for t, src in zip(self.acc, state["acc"], strict=True):
            t.copy_(src)


class ParamsEMA:
    """``params_ema(decay, mask)``: an exponential moving average of the
    post-update trainable parameters, bias-corrected like adamw's moments
    (decay ``min(decay, (1 + n) / (10 + n))`` at the n-th update), averaged
    in fp32 and kept in each parameter's dtype. Frozen parameters carry no
    copy."""

    def __init__(self, params: Iterable[nn.Parameter], decay: float = 0.999):
        self.params = list(params)
        self.decay = float(decay)
        self.ema = [p.detach().clone() for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self) -> None:
        self.count += 1
        n = torch.tensor(float(self.count), dtype=torch.float32)
        d = torch.minimum(torch.tensor(self.decay, dtype=torch.float32),
                          (1.0 + n) / (10.0 + n))
        on = {}
        for i, p in enumerate(self.params):
            e = self.ema[i]
            dd = on.setdefault(p.device, d.to(p.device))
            self.ema[i] = (dd * e.float() + (1.0 - dd) * p.float()).to(e.dtype)

    def state_dict(self) -> Dict:
        return {"count": self.count, "ema": list(self.ema)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for t, src in zip(self.ema, state["ema"], strict=True):
            t.copy_(src)


def extract_ema(ema: ParamsEMA, model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: EMA value} of every parameter of ``model``: the
    tracked ones from ``ema``, the frozen ones as they are (their EMA is the
    parameter itself)."""
    tracked = {id(p): e for p, e in zip(ema.params, ema.ema)}
    return {name: tracked.get(id(p), p.detach()) for name, p in model.named_parameters()}


def _keeps_dtype(mod: nn.Module, name: str) -> bool:
    """The buffers a cast leaves as they are: the int payloads and fp32
    scales of the quantized linears (their cached-fp copy too, as JAX keeps
    a quantized dict whole) and LoRA's ``lora_s``."""
    return isinstance(mod, QUANTIZED_LINEARS) or name == "lora_s"


@torch.no_grad()
def cast_floating_preserving_scales(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating parameters and buffers of ``model`` to ``dtype`` in
    place, except the quantized linears' buffers (int payloads, fp32 scales,
    the cached-fp copy) and LoRA's ``lora_s``: the dequant rescale stays
    fp32. A parameter's bias is cast. Int tensors pass untouched."""
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
        for name, b in list(mod.named_buffers(recurse=False)):
            if b.is_floating_point() and not _keeps_dtype(mod, name):
                mod._buffers[name] = b.to(dtype)
    return model


def cast_params(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter and buffer of ``model`` cast as
    ``cast_floating_preserving_scales`` casts them, without touching the
    model: the casts of parameters keep their autograd history, so a
    ``torch.func.functional_call`` over the result gives gradients to the
    masters (master-fp32 training). Each module is named once: a tied one
    (the proprio mixture) under its first name."""
    out = {}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        for name, p in mod.named_parameters(recurse=False):
            out[pre + name] = p.to(dtype) if p.is_floating_point() else p
        for name, b in mod.named_buffers(recurse=False):
            keep = not b.is_floating_point() or _keeps_dtype(mod, name)
            out[pre + name] = b if keep else b.to(dtype)
    return out


def get_num_params_in_billions(model: nn.Module) -> float:
    """Elements of every parameter and buffer (int payloads included), in
    billions."""
    n = sum(t.numel() for t in model.parameters()) + sum(t.numel() for t in model.buffers())
    return n / 1e9
