"""Fully-sharded data parallelism (ZeRO-3) over the data ranks, and the
sharded model's tensors against the one-card tree.

Counterpart of ``blurr_tpu/parallel/mesh.py:_augment_fsdp`` and
``pi0_param_sharding(fsdp=True)`` (``shard_params(..., fsdp=True)``). JAX
puts the 'data' mesh axis on the largest free axis of every leaf and lets
GSPMD all-gather the weights at each use and reduce-scatter their
gradients. Here ``shard_fsdp`` does it by hand, after ``shard_params``
(the TP slices):

- every parameter, and every frozen payload and scale of a quantized
  linear (``q`` / ``q8a`` / ``q4`` / ``fp`` / ``s``), keeps only its
  ``parallel/mesh.py:fsdp_dim`` slice over the data group; a tensor with no
  divisible free axis stays whole (replicated), as in JAX;
- the module that holds it gets a subclass of its own class whose
  ``__getattr__`` gathers a sharded tensor at each read
  (``module.weight``), so every read in the forward, whichever module's
  code makes it, sees the whole tensor, while ``named_parameters``,
  ``state_dict`` and the optimizer see the shard. The gather of a tensor
  that takes a gradient is ``parallel/mesh.py:gather_sum_from_group``,
  whose backward is a reduce-scatter (on gloo, which has none, a
  sum-all-reduce and the rank's slice): the shard's gradient is the sum of
  the data ranks', which the training step divides by their number. A
  frozen tensor is gathered without autograd.

The optimizer's moments, the accumulator and the EMA take the shards'
shapes (``utils/optim.py``; they are built after the sharding, as JAX's
``tx.init`` runs after ``shard_params``). The gathered weights a layer
saves for its backward stay alive until then (no re-gather in the
backward, as FSDP does): the resident bytes are the shards, the peak is
not.

**The one-card tree.** ``layout`` names, for each tensor of a sharded
model, the one-card tensor it is a slice of, its TP axis and length and its
FSDP axis; ``gather_state`` gathers a sharded model (and tensors laid out
like its parameters: the moments) into the one-card tree (rank 0 keeps it,
on the CPU), and ``cut_state`` cuts a one-card tree back into the rank's
slices. ``models/pi0/checkpoint.py`` writes and reads the one-card tree,
so a run's save serves and resumes on any mesh.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from blurr_tpu_torch.ops.quant import QUANTIZED_LINEARS
from blurr_tpu_torch.parallel.mesh import (
    Mesh,
    _own,
    all_gather,
    fsdp_dim,
    gather_sum_from_group,
)
from blurr_tpu_torch.parallel.tensor_parallel import (
    W4A8Blocks,
    rule_axes,
    state_tensors,
    tp_layout,
)

_SHARDED_BUFFERS = ("q", "q8a", "q4", "fp", "s")
_CLASSES: Dict[type, type] = {}


def _gathering_getattr(self, name: str):
    value = nn.Module.__getattr__(self, name)
    dim = self.__dict__["_fsdp_dims"].get(name)
    if dim is None or value is None:
        return value
    group = self.__dict__["_fsdp_group"]
    if value.requires_grad:
        return gather_sum_from_group(value, group, dim)
    with torch.no_grad():
        return all_gather(value, group, dim)


def _fsdp_class(cls: type) -> type:
    if cls not in _CLASSES:
        _CLASSES[cls] = type(cls.__name__, (cls,), {"__getattr__": _gathering_getattr,
                                                     "__module__": cls.__module__})
    return _CLASSES[cls]


def _holds_payload(mod: nn.Module) -> bool:
    return isinstance(mod, (*QUANTIZED_LINEARS, W4A8Blocks))


def _slots(mod: nn.Module):
    """(table, name) of each tensor of ``mod`` itself that FSDP may shard:
    its parameters, and a quantized linear's payloads and scales."""
    out = [(mod._parameters, n) for n, p in mod._parameters.items() if p is not None]
    if _holds_payload(mod):
        out += [(mod._buffers, n) for n in _SHARDED_BUFFERS if mod._buffers.get(n) is not None]
    return out


def fsdp_plan(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """{tensor name: the axis ``shard_fsdp`` shards it on} of a model
    (after ``shard_params``) over ``mesh``'s data ranks; a tensor not named
    stays whole. Needs no process group."""
    if mesh.data == 1:
        return {}
    if mesh.model == 1:  # the rule's axis stays out all the same, as in JAX
        tp_axes = rule_axes(model)
    else:
        tp_axes = {name: axis for name, (_, axis, _) in tp_layout(model, mesh).items()}
    plan = {}
    for prefix, mod in model.named_modules():  # each module once (ties)
        pre = f"{prefix}." if prefix else ""
        for table, name in _slots(mod):
            d = fsdp_dim(tuple(table[name].shape), mesh.data, tp_axes.get(pre + name),
                         transposed=isinstance(mod, nn.Linear) and name == "weight")
            if d is not None:
                plan[pre + name] = d
    return plan


@torch.no_grad()
def shard_fsdp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep only each tensor's ``fsdp_plan`` slice over ``mesh``'s data
    ranks (after ``shard_params``), in place; every module holding a
    sharded tensor gathers it at each read (the module docstring). A data
    axis of 1 leaves the model as it is."""
    plan = fsdp_plan(model, mesh)
    group = mesh.data_group
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        dims = {}
        for table, name in _slots(mod):
            d = plan.get(pre + name)
            if d is None:
                continue
            t = table[name]
            shard = _own(t.detach(), group, d).clone()
            table[name] = (nn.Parameter(shard, requires_grad=t.requires_grad)
                           if isinstance(t, nn.Parameter) else shard)
            dims[name] = d
        if dims:
            mod.__class__ = _fsdp_class(type(mod))
            mod.__dict__["_fsdp_dims"] = dims
            mod.__dict__["_fsdp_group"] = group
    return model


def fsdp_dims(model: nn.Module) -> Dict[str, int]:
    """{tensor name: the axis it is sharded on over the data ranks}."""
    out = {}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        for name, d in mod.__dict__.get("_fsdp_dims", {}).items():
            out[pre + name] = d
    return out


# ---------------------------------------------------------------------------
# The one-card tree
# ---------------------------------------------------------------------------


class Placement(NamedTuple):
    """Where a sharded tensor sits in the one-card tree."""

    name: str  # the one-card tensor's name
    tp_axis: Optional[int]  # the axis split over the model ranks
    tp_len: int  # that axis's one-card length (w4a8 scales: N, unpadded)
    fsdp_axis: Optional[int]  # the axis split over the data ranks


def layout(model: nn.Module, mesh: Mesh) -> Dict[str, Placement]:
    """{name of a tensor of the sharded ``model``: its ``Placement``}."""
    fsdp = fsdp_dims(model)
    return {name: Placement(full, axis, n, fsdp.get(name))
            for name, (full, axis, n) in tp_layout(model, mesh).items()}


def gather_tensor(t: torch.Tensor, where: Placement, mesh: Mesh) -> torch.Tensor:
    """The one-card tensor of the rank's slice ``t`` (a collective over the
    data group, then the model group)."""
    t = t.detach()
    if where.fsdp_axis is not None:
        t = all_gather(t, mesh.data_group, where.fsdp_axis)
    if where.tp_axis is not None:
        t = all_gather(t, mesh.model_group, where.tp_axis).narrow(where.tp_axis, 0,
                                                                  where.tp_len)
    return t


def cut_tensor(full: torch.Tensor, where: Placement, like: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """The rank's slice, shaped as ``like``, of the one-card tensor ``full``."""
    t = full
    if where.tp_axis is not None:
        w = like.shape[where.tp_axis]
        pad = w * mesh.model - t.shape[where.tp_axis]
        if pad:
            shape = list(t.shape)
            shape[where.tp_axis] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=where.tp_axis)
        t = t.narrow(where.tp_axis, mesh.model_rank * w, w)
    if where.fsdp_axis is not None:
        w = like.shape[where.fsdp_axis]
        t = t.narrow(where.fsdp_axis, mesh.data_rank * w, w)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{where.name}: the one-card tensor {tuple(full.shape)} does not cut "
                         f"into the rank's {tuple(like.shape)}")
    return t


def _keeps() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_state(model: nn.Module, mesh: Mesh,
                 extra: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
    """(the one-card tree {name: CPU tensor} of every parameter and
    persistent buffer, {key: {one-card name: CPU tensor}} of each ``extra``
    group of tensors laid out as the named parameters (``{key: {sharded
    name: tensor}}``: the moments)). Every rank must call it; rank 0 gets
    the trees, the others None. Over a pipe mesh each stage's layers come
    from that stage (``parallel/pipeline.py:gather_stages``)."""
    where = layout(model, mesh)
    keep = _keeps() or (mesh.pipe > 1 and mesh.data_rank == 0)
    tree = {}
    for name, t in state_tensors(model).items():
        full = gather_tensor(t, where[name], mesh)
        if keep:
            tree[where[name].name] = full.to("cpu", copy=True)
    groups = {}
    for key, tensors in (extra or {}).items():
        groups[key] = {}
        for name, t in tensors.items():
            full = gather_tensor(t, where[name], mesh)
            if keep:
                groups[key][where[name].name] = full.to("cpu", copy=True)
    if mesh.pipe > 1:
        from blurr_tpu_torch.parallel.pipeline import gather_stages

        tree = gather_stages(tree, mesh)
        groups = {key: gather_stages(g, mesh) for key, g in groups.items()}
        keep = tree is not None
    return (tree, groups) if keep else (None, None)


@torch.no_grad()
def cut_state(model: nn.Module, mesh: Mesh, tree: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy the one-card tree ``tree`` into the sharded ``model``, each
    tensor cut to the rank's slice, in place. Raises on a missing tensor."""
    where = layout(model, mesh)
    missing = sorted({w.name for w in where.values()} - tree.keys())
    if missing:
        raise ValueError(f"the tree does not fit the model: missing {missing[:8]}")
    for name, t in state_tensors(model).items():
        t.copy_(cut_tensor(tree[where[name].name], where[name], t, mesh))
    return model


def split_axes(model: nn.Module, params, mesh: Mesh):
    """[(split over the model ranks, split over the data ranks[, staged on
    one pipe rank])] of each of ``params`` (parameters of the sharded
    ``model``; the third entry on a pipeline mesh): what
    ``utils/optim.py:AdamW``'s clip needs for its global norm."""
    where = layout(model, mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    out = [(where[names[id(p)]].tp_axis is not None, where[names[id(p)]].fsdp_axis is not None)
           for p in params]
    if mesh.pipe > 1:
        from blurr_tpu_torch.parallel.pipeline import is_staged

        out = [(*axes, is_staged(names[id(p)])) for axes, p in zip(out, params)]
    return out


def unshard_module(mod: nn.Module, mesh: Mesh) -> nn.Module:
    """A one-card copy of ``mod``, a module no TP rule splits (OpenVLA-OFT's
    head): its FSDP shards gathered (a collective: every rank calls it) and
    its modules back in their own classes."""
    import copy

    group = mesh.data_group
    out = copy.deepcopy(mod, memo={id(group): group})  # a process group is not copied
    for sub in out.modules():
        dims = sub.__dict__.pop("_fsdp_dims", None)
        if dims is None:
            continue
        sub.__dict__.pop("_fsdp_group")
        sub.__class__ = sub.__class__.__mro__[1]
        for name, d in dims.items():
            table = sub._parameters if name in sub._parameters else sub._buffers
            full = all_gather(table[name].detach(), group, d)
            table[name] = nn.Parameter(full) if isinstance(table[name], nn.Parameter) else full
    return out
