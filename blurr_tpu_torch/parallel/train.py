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
``normal(k1)`` and ``beta(k2, 1.5, 1)`` from the step's key.

**Over a mesh of ranks** (``mesh``; the model sharded by
``parallel/mesh.py:shard_params`` and, under FSDP,
``parallel/fsdp.py:shard_fsdp`` before the optimizer is built, as JAX's
``tx.init`` runs after ``shard_params``): every rank is handed the GLOBAL
batch and the global noise and t (every rank draws the same draws from the
same generator state) and takes its data rank's rows (``data_rows``,
JAX's ``batch_sharding``), so ``--dp N`` trains what ``--dp 1`` does. The
model ranks compute the loss of their rows together through the TP layers'
differentiable collectives. The gradients of replicated parameters are
averaged over the data ranks (one sum-all-reduce per bucket, then / dp);
an FSDP shard's gradient arrives summed by its gather's reduce-scatter and
is divided likewise. The returned loss is the mean over the data ranks.

**Sequence parallelism** (``sp``; a ``make_mesh(data, model, seq)``
mesh): the seq ranks of a data row split its vlm and SigLIP tokens and
each holds the proprio and action rows whole, so each computes the whole
loss. Each seq rank differentiates its loss divided by the seq size, and
every gradient is summed over the seq group, so a replicated row counts
once (the K/V gathers' reduce-scatters sum the same shares); the loss is
the mean over the seq ranks. **Pipeline parallelism**
(``pipeline``, a ``parallel/pipeline.py:PipelineCtx``): the loss is the
GPipe schedule's, the same on every stage; a staged parameter's gradient
stays on its stage and every replicated parameter's is summed over the
pipe group (a stage that does not read it adds zeros). The data ranks'
mean follows either. Not ported: ``donate``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from blurr_tpu_torch.utils.optim import AdamW, GradAccumulator, ParamsEMA, cast_params

# the elements of one bucket of the data ranks' gradient all-reduce
GRAD_BUCKET = 1 << 25

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
              noise, t, remat: bool = False, pipeline=None, sp=None) -> torch.Tensor:
    """Pi-0's loss on ``_BATCH_KEYS`` and the step's (noise, t)."""
    return model.flow_loss(input_ids, attention_mask, pixel_values, proprios, actions, t, noise,
                           remat=remat, pipeline=pipeline, sp=sp)


class _LossAndGrads(nn.Module):
    """The loss and the gradients of ``wrt``, computed inside one call so
    that ``torch.func.functional_call`` keeps the cast copies in place for
    the backward too (``remat`` recomputes layers there). The gradients
    are those of the loss times ``share``; the loss is returned as it is."""

    def __init__(self, model: nn.Module, loss_fn: Callable, kwargs: Dict, share: float):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn
        self.kwargs, self.share = kwargs, share

    def forward(self, args, remat: bool, wrt):
        loss = self.loss_fn(self.model, *args, remat=remat, **self.kwargs)
        scaled = loss if self.share == 1 else loss * self.share
        return loss, torch.autograd.grad(scaled, wrt, allow_unused=True)


def sum_over(grads: List[torch.Tensor], which: Sequence[int], group) -> List[torch.Tensor]:
    """``grads`` with those at the indices ``which`` sum-all-reduced over
    ``group``, in buckets of at most GRAD_BUCKET elements of one dtype."""
    from blurr_tpu_torch.parallel.mesh import all_reduce_sum

    grads, todo = list(grads), list(which)
    while todo:
        dtype, bucket, n = grads[todo[0]].dtype, [], 0
        for i in list(todo):
            if grads[i].dtype == dtype and (not bucket or n + grads[i].numel() <= GRAD_BUCKET):
                bucket.append(i)
                n += grads[i].numel()
                todo.remove(i)
        flat = all_reduce_sum(torch.cat([grads[i].reshape(-1) for i in bucket]), group)
        for i, part in zip(bucket, flat.split([grads[i].numel() for i in bucket])):
            grads[i] = part.view_as(grads[i])
    return grads


def average_over_data(grads: List[Optional[torch.Tensor]], params, summed: Sequence[bool],
                      mesh) -> List[torch.Tensor]:
    """The mean over ``mesh``'s data ranks of each rank's gradient: those not
    ``summed`` yet are sum-all-reduced in buckets of at most GRAD_BUCKET
    elements of one dtype; every one is then divided by the number of data
    ranks. A None gradient counts as zero."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    grads = sum_over(grads, [i for i, done in enumerate(summed) if not done], mesh.data_group)
    return [g / mesh.data for g in grads]


def sum_over_stages(grads: List[torch.Tensor], replicated: Sequence[int], mesh
                    ) -> List[torch.Tensor]:
    """Every replicated parameter's gradient summed over the pipe group
    (each is read on one stage; the others hold zeros)."""
    return sum_over(grads, replicated, mesh.pipe_group)


def sequence_share(mesh) -> float:
    """The share of its loss a seq rank differentiates: 1 / seq, so that a
    row every seq rank holds counts once in the gradients' sum."""
    return 1.0 / mesh.seq


def make_train_step(model: nn.Module, optimizer: AdamW, remat: bool = False,
                    compute_dtype: Optional[torch.dtype] = None, accum_steps: int = 1,
                    ema: Optional[ParamsEMA] = None, loss_fn: Callable = flow_loss,
                    batch_keys: Sequence[str] = _BATCH_KEYS, mesh=None, pipeline=None):
    """``step(batch, *extra) -> loss`` (a 0-d fp32 tensor, left on the
    device): one micro-batch's ``loss_fn(model, *batch[batch_keys],
    *extra, remat=remat)`` and the gradients of ``optimizer.params``
    (Pi-0's default: ``step(batch, noise, t)``); with ``accum_steps`` k > 1
    the parameters update on every k-th call with the mean of the k
    gradients (``GradAccumulator``, ``optax.MultiSteps``), and the EMA
    follows each update. ``step.accumulator`` holds the accumulator (None
    for k = 1). Over a ``mesh`` (the module docstring) ``batch`` and
    ``extra`` are the global ones, every entry batch-first. ``pipeline``
    (its mesh is ``mesh``) reaches ``loss_fn`` as ``pipeline=``, and a
    ``mesh`` with a seq axis as ``sp=mesh``."""
    trainable = optimizer.params
    acc = GradAccumulator(trainable, accum_steps) if accum_steps > 1 else None
    kwargs = {}
    seq = mesh is not None and mesh.seq > 1
    if pipeline is not None:
        kwargs["pipeline"] = pipeline
    if seq:
        kwargs["sp"] = mesh
    holder = _LossAndGrads(model, loss_fn, kwargs, sequence_share(mesh) if seq else 1.0)
    keys = tuple(batch_keys)
    data = mesh is not None and mesh.data > 1
    names = {id(p): n for n, p in model.named_parameters()}
    summed = [False] * len(trainable)
    if data:
        from blurr_tpu_torch.parallel.fsdp import fsdp_dims

        sharded = fsdp_dims(model)
        summed = [names[id(p)] in sharded for p in trainable]
    replicated = []
    if pipeline is not None and mesh.pipe > 1:
        from blurr_tpu_torch.parallel.pipeline import is_staged

        replicated = [i for i, p in enumerate(trainable) if not is_staged(names[id(p)])]

    def step(batch: Dict[str, torch.Tensor], *extra: torch.Tensor):
        from blurr_tpu_torch.parallel.mesh import all_reduce_sum, data_rows

        batch = cast_batch(batch, compute_dtype or param_dtype(model))
        args = tuple(batch[k] for k in keys) + extra
        if data:
            args = tuple(data_rows(a, mesh) for a in args)
        if compute_dtype is None:
            loss, grads = holder(args, remat, trainable)
        else:
            params = {f"model.{k}": v for k, v in cast_params(model, compute_dtype).items()}
            # each module once: setting the action mixture's tensors sets the
            # tied proprio module's, and each is restored once after the call
            loss, grads = torch.func.functional_call(holder, params, (args, remat, trainable),
                                                     tie_weights=False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
        if seq:
            grads = sum_over(grads, range(len(grads)), mesh.seq_group)
            loss = all_reduce_sum(loss.detach().reshape(1), mesh.seq_group)[0] / mesh.seq
        if replicated:
            grads = sum_over_stages(grads, replicated, mesh)
        if data:
            grads = average_over_data(grads, trainable, summed, mesh)
            loss = all_reduce_sum(loss.detach().reshape(1), mesh.data_group)[0] / mesh.data
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


# ---------------------------------------------------------------------------
# The ranks of a trainer (scripts/train_pi0_flow_torch.py,
# scripts/train_openvla_lora_torch.py)
# ---------------------------------------------------------------------------

# how long rank 0 waits for the other ranks' last reply after its own run
RANKS_DEADLINE_S = 1800.0


def kernel_launches() -> Dict[str, int]:
    """{kernel name: launches so far} of the kernels a training step can
    run (each wrapper's count)."""
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul

    return {k.__name__: k.launches for k in (flash_attention, int4_matmul, int8_matmul)}


def rank_summary(run) -> dict:
    """What a rank of a training run reports (picklable): its losses, its
    kernels' launches in the training steps, the bytes of the parameters
    and buffers and of the optimizer's moments it holds, and its device's
    peak allocation."""

    def nbytes(ts):
        return int(sum(t.numel() * t.element_size() for t in ts))

    model, opt = run.model, run.optimizer
    device = next(model.parameters()).device
    return {
        "rank": run.rank, "losses": [float(x) for x in run.losses],
        "launches": dict(run.launches),
        "param_bytes": nbytes([*model.parameters(), *model.buffers()]),
        "moment_bytes": nbytes([*opt.mu, *opt.nu]),
        "peak_bytes": (int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda"
                       else 0),
        "rows": dict(getattr(run, "rows", {})),
    }


def record_token_rows(model: nn.Module) -> Dict[str, List[int]]:
    """{"siglip": [...], "vlm": [...]}: the token rows the input of each
    SigLIP layer and of each vlm mixture layer's query projection had in
    the last forward that ran it (forward pre-hooks on the model; a
    sequence rank's share of the tokens)."""
    rows: Dict[str, List[int]] = {"siglip": [], "vlm": []}

    def hook(key, i):
        def record(_mod, args):
            seen = rows[key]
            seen.extend([0] * (i + 1 - len(seen)))
            seen[i] = int(args[0].shape[-2])
        return record

    for i, layer in enumerate(model.vision_tower.layers):
        layer.register_forward_pre_hook(hook("siglip", i))
    for i, layer in enumerate(model.joint["vlm"].layers):
        if hasattr(layer, "q_proj"):
            layer.q_proj.register_forward_pre_hook(hook("vlm", i))
    return rows


def _rank_main(rank: int, conn, train: Callable, argv, world: int, init_method: str) -> None:
    """A spawned rank of a trainer: the same run as rank 0's, its summary
    sent back."""
    try:
        run = train(argv, rank=rank, world=world, init_method=init_method)
        dist.barrier()
        conn.send(("ok", rank_summary(run)))
    except BaseException as exc:  # the reason goes to rank 0
        import traceback

        conn.send(("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def join_mesh(rank: int, world: int, init_method, device, dp: int, tp: int, sp: int = 1,
              pp: int = 1):
    """(this rank's device, its mesh, or None for one rank) of a trainer's
    rank: ``dp x sp x tp`` (``make_mesh``) or, with ``pp`` > 1, ``dp x pp``
    (``make_pipeline_mesh``), over the process group joined at
    ``init_method`` (a spawned group) or already joined (a launcher's,
    ``init_multihost``)."""
    from blurr_tpu_torch.parallel.mesh import init_ranks, make_mesh, multihost_device
    from blurr_tpu_torch.parallel.pipeline import make_pipeline_mesh

    if world == 1:
        return torch.device(device), None
    if init_method is not None:
        _, device = init_ranks(rank, world, init_method, device)
    else:
        device = multihost_device(device)
    return device, make_pipeline_mesh(pp, dp) if pp > 1 else make_mesh(dp, tp, sp)


def run_ranks(train: Callable, argv, dp: int, tp: int, multihost: bool, device, sp: int = 1,
              pp: int = 1):
    """Run ``train(argv, rank=, world=, init_method=)`` (a trainer's whole
    run; it returns a namespace) on ``dp * tp * sp * pp`` ranks and return
    rank 0's namespace, its ``ranks`` the ``rank_summary`` of every rank.

    ``multihost``: this process joins the launcher's process group
    (``parallel/mesh.py:init_multihost``) and runs as the rank it is given;
    the world must be ``dp * tp * sp * pp`` (without a launcher it logs
    JAX's warning and goes on as below). Otherwise one rank runs as it is, and a group of
    several is spawned by rank 0 (``Workers``), which joins them by a
    deadline."""
    import sys

    from blurr_tpu_torch.parallel.mesh import (
        PG_TIMEOUT_S,
        Workers,
        free_tcp_init_method,
        init_multihost,
    )

    world = dp * tp * sp * pp
    if multihost:
        rank = init_multihost(device)
        if dist.is_initialized():
            try:
                if dist.get_world_size() != world:
                    axes = " x ".join(f"--{k} {v}" for k, v in
                                      (("dp", dp), ("tp", tp), ("sp", sp), ("pp", pp))
                                      if k in ("dp", "tp") or v > 1)
                    sys.exit(f"--multihost: the launcher started {dist.get_world_size()} "
                             f"processes, but {axes} needs {world}")
                run = train(argv, rank=rank, world=world, init_method=None)
                run.ranks = [rank_summary(run)]
                return run
            finally:
                dist.destroy_process_group()
    if world == 1:
        run = train(argv)
        run.ranks = [rank_summary(run)]
        return run
    init_method = free_tcp_init_method()
    workers = Workers(world, _rank_main, (train, argv, world, init_method))
    try:
        try:
            run = train(argv, rank=0, world=world, init_method=init_method)
            dist.barrier()
        except BaseException as exc:
            errs = workers.pending_errors()
            if errs:
                raise RuntimeError("; ".join(errs)) from exc
            raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        replies = workers.replies(RANKS_DEADLINE_S)
    finally:
        workers.join(PG_TIMEOUT_S)
    run.ranks = [rank_summary(run), *(r[1] for r in replies)]
    return run
