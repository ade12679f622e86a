"""Pipeline parallelism over the joint transformer's layers (GPipe).

Counterpart of ``blurr_tpu/parallel/pipeline.py`` (``PipelineCtx``,
``make_pipeline_mesh``, ``pipelined_scan``'s microbatch rule and
``shard_params_pipeline``). JAX shards the stacked [L, ...] layer axis
over a 'pipe' mesh axis and runs an SPMD tick loop in one ``shard_map``,
rotating the carry with ``ppermute``. Here each stage is a process (a
rank of ``torch.distributed``) holding the layers [s * L / S, (s + 1) * L
/ S) and nothing of the others', and the schedule is GPipe written out:

    forward:  for each microbatch m: receive the hidden states from stage
              s - 1 (stage 0 embeds them), run the stage's layers, send
              them to stage s + 1 (the last stage: the microbatch's loss)
    backward: for each microbatch, in reverse: receive the gradient of the
              stage's output from stage s + 1, back-propagate it through
              the stage's layers, send the gradient of its input to s - 1

Only the hidden states and their gradients travel; the batch-constant
inputs (the rope tables, the mask, the time conditioning) are made on each
stage from the microbatch's rows, as JAX's ``consts``. ``gpipe`` is an
``autograd.Function`` over the stage's parameters: its forward runs the
forward schedule and keeps each microbatch's graph, its backward runs the
backward schedule, so ``flow_loss(pipeline=)`` is an ordinary loss whose
gradients ``torch.autograd.grad`` gives. The loss is the batch mean, each
microbatch's weighted by its rows, computed on the last stage and
broadcast: every stage returns it.

A staged parameter's gradient stays on its stage. A replicated parameter
(SigLIP, the projector, the token table, the encoders, the decoder, the
final norms) is read on one stage only (the embeddings on stage 0, the
decoder on the last), so the other stages' gradients of it are zeros,
and the training step sums them over the pipe group
(``parallel/train.py``). Under a ``('data', 'pipe')`` mesh each data row
runs its own pipeline on its rows.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from blurr_tpu_torch.parallel.mesh import Mesh, broadcast, build_mesh, group_peer, recv, send

_STAGED = re.compile(r"^joint\.[^.]+\.layers\.\d+\.")
# JAX's message (shard_params_pipeline), the path a mixture's layers
UNEVEN_STAGES = "{path}: {n} layers not divisible by {stages} pipeline stages"


@dataclass(frozen=True)
class PipelineCtx:
    """How to pipeline: the ('data', 'pipe') mesh and the microbatch count
    (None: ``microbatch_count``'s default)."""

    mesh: Mesh
    microbatches: Optional[int] = None


def make_pipeline_mesh(stages: int, data: int = 1) -> Mesh:
    """JAX's ``('data', 'pipe')`` mesh over the initialised process group:
    rank = d * stages + p, a pipe group per data row. Every rank calls it."""
    return build_mesh(data=data, pipe=stages)


def microbatch_count(batch: int, stages: int, data: int = 1,
                     microbatches: Optional[int] = None) -> int:
    """The microbatches a (global) ``batch`` goes through the pipeline in,
    as JAX's ``pipelined_scan`` has it (``pipeline.py:141-157``): an
    explicit count must divide the batch into rows the data axis divides;
    the default is the most microbatches that keep >= 8 rows per data rank
    in each and at most max(stages, batch // (8 * data)), else the largest
    valid divisor. JAX's messages, raised as ``ValueError``."""
    if microbatches:
        if batch % microbatches:
            raise ValueError(f"batch {batch} not divisible by {microbatches} microbatches")
        if (batch // microbatches) % data:
            raise ValueError(f"microbatch rows {batch // microbatches} not divisible by the "
                             f"'data' axis ({data})")
        return microbatches
    cap = max(stages, batch // (8 * data))
    valid = [m for m in range(min(cap, batch), 0, -1)
             if batch % m == 0 and (batch // m) % data == 0]
    if not valid:
        raise ValueError(f"no microbatch count divides batch {batch} with data axis {data}; "
                         "pad the batch or set ctx.microbatches")
    return valid[0]


def stage_layers(n_layers: int, mesh: Mesh) -> range:
    """The layers of this rank's stage: [s * L / S, (s + 1) * L / S)."""
    if n_layers % mesh.pipe:
        raise ValueError(f"{n_layers} layers not divisible by {mesh.pipe} pipeline stages")
    w = n_layers // mesh.pipe
    return range(mesh.pipe_rank * w, (mesh.pipe_rank + 1) * w)


def is_staged(name: str) -> bool:
    """Whether the tensor ``name`` belongs to a joint layer (held by one
    stage) rather than replicated on every stage."""
    return bool(_STAGED.match(name))


class DroppedLayer(nn.Module):
    """Another stage's layer: it holds nothing, and is never run."""


@torch.no_grad()
def shard_params_pipeline(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep on this stage the layers of its range of every joint mixture
    (``model.joint``), in place, and drop the others (a ``DroppedLayer`` at
    their index, so every tensor keeps its one-card name); everything else
    stays replicated (JAX ``pipeline.py:260-295``). The tied proprio
    mixture is the action module, cut once."""
    if mesh.pipe == 1:
        return model
    for name, mixture in model.joint.items():
        n = len(mixture.layers)
        if n % mesh.pipe:
            raise ValueError(UNEVEN_STAGES.format(path=f"joint.{name}.layers", n=n,
                                                  stages=mesh.pipe))
        keep = stage_layers(n, mesh)
        for i in range(n):
            if i not in keep:
                mixture.layers[i] = DroppedLayer()
    return model


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


class _Schedule:
    """GPipe over one pipe group: ``stage_fn(m, carry)`` runs microbatch m
    on this stage (``carry`` None on the first) and returns the hidden
    states to send on, or, on the last stage, the microbatch's share of
    the loss (a 0-d tensor); ``carry_like`` is the (shape, dtype) of each
    tensor a stage receives (every microbatch has the same rows)."""

    def __init__(self, stage_fn: Callable, n_micro: int, carry_like: Sequence, mesh: Mesh,
                 params: Sequence[torch.Tensor], device):
        self.stage_fn, self.n_micro, self.carry_like = stage_fn, n_micro, carry_like
        self.group, self.params, self.device = mesh.pipe_group, list(params), device
        self.first = mesh.pipe_rank == 0
        self.last = mesh.pipe_rank == mesh.pipe - 1
        self.prev = None if self.first else group_peer(self.group, -1)
        self.next = None if self.last else group_peer(self.group, 1)
        self.src = dist.get_global_rank(self.group, mesh.pipe - 1)
        self.kept: List[Tuple[Optional[List[torch.Tensor]], object]] = []

    def forward(self, grad: bool) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for m in range(self.n_micro):
            carry = None
            if not self.first:
                carry = recv(self.carry_like, self.prev, self.group, self.device)
                if grad:
                    carry = [c.requires_grad_() for c in carry]
            with torch.set_grad_enabled(grad):
                out = self.stage_fn(m, carry)
            if self.last:
                total = total + out.detach().float()
            else:
                send(out, self.next, self.group)
            if grad:
                self.kept.append((carry, out))
        return broadcast(total, self.src, self.group)

    def backward(self, g: torch.Tensor) -> List[Optional[torch.Tensor]]:
        sums: List[Optional[torch.Tensor]] = [None] * len(self.params)
        while self.kept:
            carry, out = self.kept.pop()
            if self.last:
                outs, gouts = [out], [g.to(out.dtype)]
            else:
                outs = list(out)
                gouts = recv([(o.shape, o.dtype) for o in outs], self.next, self.group,
                             self.device)
            ins = self.params + (carry or [])
            live = [(o, go) for o, go in zip(outs, gouts) if o.requires_grad]
            gs = (torch.autograd.grad([o for o, _ in live], ins, [go for _, go in live],
                                      allow_unused=True)
                  if live else [None] * len(ins))
            for i, gi in enumerate(gs[:len(self.params)]):
                if gi is not None:
                    sums[i] = gi if sums[i] is None else sums[i] + gi
            if carry is not None:
                send([torch.zeros_like(c) if gi is None else gi
                      for c, gi in zip(carry, gs[len(self.params):])], self.prev, self.group)
        return sums


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, *params):
        ctx.schedule = schedule
        return schedule.forward(grad=True)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.schedule.backward(g))


def gpipe(stage_fn: Callable, n_micro: int, carry_like: Sequence, mesh: Mesh,
          params: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The loss of ``n_micro`` microbatches through the pipe group of
    ``mesh`` (``_Schedule``), the same 0-d fp32 tensor on every stage.
    With gradients on, it is differentiable with respect to ``params``
    (the stage's tensors that take a gradient): every stage must then
    differentiate it, as every stage takes part in the backward."""
    schedule = _Schedule(stage_fn, n_micro, carry_like, mesh, params, device)
    if torch.is_grad_enabled() and params:
        return _GPipe.apply(schedule, *params)
    return schedule.forward(grad=False)


def pipelined_flow_loss(model: nn.Module, inputs: Sequence[torch.Tensor], ctx: PipelineCtx,
                        remat: bool = False) -> torch.Tensor:
    """Pi-0's ``flow_loss`` over ``ctx``'s pipe group: the rank's rows of
    the batch (its data rank's) in ``microbatch_count`` microbatches, each
    through ``PiZero.flow_stage`` on this stage's layers; the batch mean of
    the microbatches' losses, the same on every stage."""
    mesh = ctx.mesh
    rows = inputs[0].shape[0]
    n_micro = microbatch_count(rows * mesh.data, mesh.pipe, mesh.data, ctx.microbatches)
    per = rows // n_micro
    layers = stage_layers(model.joint_spec.num_hidden_layers, mesh)
    mix = model.joint_spec.mixtures
    dtype = model.embed_tokens.dtype
    carry = [((per, inputs[0].shape[1], mix["vlm"].hidden_size), dtype),
             ((per, inputs[3].shape[1], mix["proprio"].hidden_size), dtype),
             ((per, inputs[4].shape[1], mix["action"].hidden_size), dtype)]

    def stage_fn(m, received):
        out = model.flow_stage([x[m * per:(m + 1) * per] for x in inputs], layers, received,
                               remat)
        return out * (per / rows) if layers.stop == model.joint_spec.num_hidden_layers else out

    params = [p for p in model.parameters() if p.requires_grad]
    return gpipe(stage_fn, n_micro, carry, mesh, params, inputs[0].device)


# ---------------------------------------------------------------------------
# The one-card tree of a pipelined model (models/pi0/checkpoint.py)
# ---------------------------------------------------------------------------


def gather_stages(tree: Optional[Dict[str, torch.Tensor]], mesh: Mesh
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The one-card tree on the first stage of data row 0: its own
    ``tree`` ({one-card name: CPU tensor}; the replicated tensors from it)
    with every other stage's staged tensors. Every rank of data row 0
    calls it; the others get None, as do the other stages."""
    if mesh.data_rank:
        return None
    group = mesh.pipe_group
    head = dist.get_global_rank(group, 0)
    if mesh.pipe_rank:
        staged = {n: t for n, t in tree.items() if is_staged(n)}
        dist.send_object_list([[(n, tuple(t.shape), t.dtype) for n, t in staged.items()]],
                              head, group=group)
        send(list(staged.values()), head, group)
        return None
    tree = dict(tree)
    for stage in range(1, mesh.pipe):
        src = dist.get_global_rank(group, stage)
        meta = [None]
        dist.recv_object_list(meta, src, group=group)
        got = recv([(shape, dtype) for _, shape, dtype in meta[0]], src, group, "cpu")
        tree.update(zip((n for n, _, _ in meta[0]), got))
    return tree


def gather_stage_objects(obj, mesh: Mesh) -> Optional[list]:
    """Every stage's ``obj`` (picklable), in stage order, on the first
    stage of data row 0 (None elsewhere); every rank of data row 0 calls
    it."""
    if mesh.data_rank:
        return None
    group = mesh.pipe_group
    if mesh.pipe_rank:
        dist.send_object_list([obj], dist.get_global_rank(group, 0), group=group)
        return None
    out = [obj]
    for stage in range(1, mesh.pipe):
        got = [None]
        dist.recv_object_list(got, dist.get_global_rank(group, stage), group=group)
        out.append(got[0])
    return out
