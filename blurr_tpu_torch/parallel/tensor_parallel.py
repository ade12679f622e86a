"""Tensor-parallel layers: the rank's slice of a linear or an embedding and
the collectives that join the slices.

JAX has no such module: GSPMD inserts the collectives its ``NamedSharding``
rules (``blurr_tpu/parallel/mesh.py:_spec_for_path``) imply. Here they are
explicit, and these wrappers are the port's form of those rules
(``parallel/mesh.py:rule_for`` picks one per module):

- ``ColumnParallelLinear`` holds the rank's output slice of any of the
  port's linears (``nn.Linear``, ``Int8Linear``, ``CachedFpLinear``,
  ``W8A8Linear``, ``LoRALinear`` over any of them) and takes the whole
  input; its output is the rank's columns (heads, intermediate columns).
  Under the vocabulary rule (LLaMA's ``lm_head``) the columns are gathered,
  so greedy decoding takes its argmax over the whole vocabulary.
- ``RowParallelLinear`` holds the rank's input slice, takes the rank's
  slice of the input (or the whole input, which it slices) and sums the
  ranks' partial products: the bias is added once, after the sum. A w8a8
  product quantizes its activations per token with the absmax over the
  WHOLE K (``ops/quant.py:_quantize_activations``), as JAX's, where GSPMD
  reduces over the full axis: the ranks' absmaxes go through a
  max-all-reduce first, and the exact int32 partial dots through a
  sum-all-reduce, so the product is the single-rank one bit for bit. An
  int8 weight-only product (K3 at K/tp) sums its fp32 partial dots, then
  scales; an int8 weight-only product quantizes no activation, so there is
  no scale to reduce.
- The w4a8 rule (JAX ``mesh.py:148-163`` and
  ``pallas_int4_matmul.py:int4_matmul_spmd``): a ``q4`` weight under any TP
  parent, row-parallel ones included, splits on its block axis NB only.
  ``W4A8Blocks`` holds the rank's NB/tp contiguous blocks (the packing
  re-laid by ``ops/quant.py:repack_w4a8`` so that NB divides) and the
  matching columns of the padded scales; the input is whole on every rank
  (a row parent gathers it first), each rank runs K2 on its blocks, and
  the blocks are all-gathered and cut back to N, as ``w4a8_mm`` cuts them.
  No group's int32 sum is ever split, so every w4a8 product is the
  single-rank one bit for bit. A rank's blocks need not be its heads or
  intermediate columns (at tp=2 Pi-0's vlm 16,384 packs as 12 blocks of
  1,408: 8,448 columns a rank), so a column parent gathers first, then
  takes its columns. Only where the packing has no padding (NB * BN = N)
  are the rank's blocks exactly its columns, and there the gather is
  skipped.
- ``VocabParallelEmbedding`` holds the rank's ``V / tp`` rows of a token
  table: a lookup takes the ids in its range (zero elsewhere) and the ranks
  sum (exact: each id is held once); ``logits`` (a head tied to the table)
  gathers the vocabulary-split logits.
- ``ReplicatedLinear`` holds a whole linear inside a split region: Pi-0's
  ``k_proj`` / ``v_proj`` (Gemma's one KV head, whole on every rank), whose
  output each rank's query heads read in part.

**Gradients** (training over the model axis). Every collective is the
differentiable one of ``parallel/mesh.py``: a column layer's whole input
goes in through ``copy_to_group`` (each rank's gradient of it is a partial
sum); the row sum, the embedding's lookup sum and the LoRA delta of a row
layer through ``reduce_from_group``; gathered outputs (the vocabulary
logits, a w4a8 weight's blocks) through ``gather_from_group``, which hands
each rank the gradient of its own slice, and a column parent's cut of the
gathered blocks through ``scatter_to_group``, which gathers the ranks'
column gradients back (a rank's blocks are not its columns). A replicated
tensor that meets a split one (a column layer's ``lora_a``, a row layer's
``lora_b``, every tensor of a ``ReplicatedLinear``) is read through
``copy_to_group``, so its gradient sums the ranks' partial ones. The w8a8
and int8 row products are ``torch.autograd.Function``s whose forward is
the served one bit for bit and whose backward is straight through on the
rank's K slice, ``g @ deq(W_k)^T`` (JAX's ``_int8_dot_ste``); a w4a8
product is ``ops/quant.py``'s ``_Int4DotSTE`` on the rank's blocks, its
partial input gradient summed by the ``copy_to_group`` in front of it.

``tp_layout`` names, for each tensor of a sharded model, the tensor of the
one-card model it is a slice of and how (the axis, the whole length), so
that a sharded model's tensors gather into the one-card tree and a
one-card tree cuts back into them (``parallel/fsdp.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.ops.lora import LoRALinear
from blurr_tpu_torch.ops.quant import (
    QUANTIZED_LINEARS as QUANT_MODULES,
    CachedFpLinear,
    Int8Linear,
    W4A8Linear,
    W8A8Linear,
    _clip,
    _div,
    cached_fp_mm,
    int8_dot,
    int8_mm,
    lora_delta,
    w4a8_mm,
)
from blurr_tpu_torch.parallel.mesh import (
    COLUMN,
    ROW,
    VOCAB,
    Mesh,
    all_reduce_max,
    all_reduce_sum,
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    scatter_to_group,
)

_LINEARS = (nn.Linear, Int8Linear, CachedFpLinear, W8A8Linear, W4A8Linear, LoRALinear)


def is_linear(mod: nn.Module) -> bool:
    """A module the TP wrappers take."""
    return isinstance(mod, _LINEARS)


def _span(n: int, mesh: Mesh, what: str) -> Tuple[int, int]:
    """[lo, hi) of this rank's equal share of ``n``."""
    if n % mesh.model:
        raise ValueError(f"{what} of {n} does not split over {mesh.model} model ranks")
    w = n // mesh.model
    return mesh.model_rank * w, (mesh.model_rank + 1) * w


def _cut(t: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return t.narrow(dim, lo, hi - lo).contiguous().clone()


@torch.no_grad()
def column_slice(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of a vector cut with a column layer's output."""
    return _cut(t.detach(), 0, *_span(t.shape[0], mesh, "output"))


class W4A8Blocks(nn.Module):
    """The rank's contiguous blocks of a w4a8 weight (the w4a8 rule of the
    module docstring): buffers ``q4`` [NB/tp, K/2, BN] and ``s`` [G,
    NB/tp * BN] (the matching columns of the scales padded to NB * BN).
    Takes the whole input. ``cols`` None returns the whole output [..., N];
    ``cols`` (lo, hi) returns those columns of it, without a gather where
    they are exactly the rank's blocks."""

    def __init__(self, q4: torch.Tensor, s: torch.Tensor, n: int, mesh: Mesh,
                 cols: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.register_buffer("q4", q4)
        self.register_buffer("s", s)
        self.n, self.cols, self.group = n, cols, mesh.model_group
        self.in_features = 2 * q4.shape[1]
        self.out_features = n if cols is None else cols[1] - cols[0]
        self.gathers = not (cols is not None and s.shape[1] * mesh.model == n)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: W4A8Linear, mesh: Mesh, cols=None) -> "W4A8Blocks":
        nb, _, bn = lin.q4.shape
        lo, hi = _span(nb, mesh, "w4a8 block axis")
        n = lin.s.shape[1]
        s_pad = F.pad(lin.s, (0, nb * bn - n))
        return cls(_cut(lin.q4, 0, lo, hi), _cut(s_pad, 1, lo * bn, hi * bn), n, mesh, cols)

    def forward(self, x, activation_clip: Optional[float] = None):
        y = w4a8_mm(x, {"q4": self.q4, "s": self.s}, activation_clip)
        if not self.gathers:
            return y
        y = gather_from_group(y, self.group, -1)[..., :self.n]
        # the columns are the rank's equal span of N (a column parent's)
        return y if self.cols is None else scatter_to_group(y, self.group, -1)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"blocks={self.q4.shape[0]}, cols={self.cols}, gathers={self.gathers}")


def _local_linear(mod: nn.Module, dim: str, lo: int, hi: int, keep_bias: bool) -> nn.Module:
    """A copy of linear ``mod`` (not w4a8) cut to [lo, hi) of its output
    (``dim`` "out") or input ("in"); ``keep_bias`` False drops the bias (a
    row layer adds it after the sum)."""
    if type(mod) is nn.Linear:
        w = mod.weight
        weight = _cut(w, 0, lo, hi) if dim == "out" else _cut(w, 1, lo, hi)
        out = nn.Linear(weight.shape[1], weight.shape[0], bias=False,
                        device="meta", dtype=w.dtype)
        out.weight = nn.Parameter(weight, requires_grad=w.requires_grad)
        if keep_bias and mod.bias is not None:
            b = mod.bias if dim == "in" else mod.bias[lo:hi]
            out.bias = nn.Parameter(b.detach().clone(), requires_grad=mod.bias.requires_grad)
        return out
    bias = None
    if keep_bias and mod.bias is not None:
        b = mod.bias if dim == "in" else mod.bias[lo:hi]
        bias = nn.Parameter(b.detach().clone(), requires_grad=mod.bias.requires_grad)
    axis = 1 if dim == "out" else 0  # the quantized layouts are [in, out]
    if isinstance(mod, Int8Linear):
        s = mod.s[lo:hi].clone() if dim == "out" else mod.s
        return Int8Linear(_cut(mod.q, axis, lo, hi), s, bias)
    if isinstance(mod, CachedFpLinear):
        return CachedFpLinear(_cut(mod.fp, axis, lo, hi), bias)
    if isinstance(mod, W8A8Linear):
        s = mod.s[lo:hi].clone() if dim == "out" else mod.s
        return W8A8Linear(_cut(mod.q8a, axis, lo, hi), s, bias)
    raise TypeError(f"no TP slice of a {type(mod).__name__}")


def _base(mod: nn.Module) -> nn.Module:
    return mod.base if isinstance(mod, LoRALinear) else mod


class ColumnParallelLinear(nn.Module):
    """The rank's output slice of a linear (``local``); the whole input in,
    the rank's columns out, or with ``gather`` (the vocabulary rule) every
    rank's columns gathered."""

    def __init__(self, local: nn.Module, mesh: Mesh, in_features: int, out_features: int,
                 gather: bool = False):
        super().__init__()
        self.local = local
        self.group, self.gather = mesh.model_group, gather
        self.in_features, self.out_features = in_features, out_features

    def forward(self, x, activation_clip: Optional[float] = None):
        g = self.group
        x = copy_to_group(x, g)
        local = self.local
        if isinstance(local, LoRALinear):  # lora_a is whole: its gradient sums
            y = local.product(x, activation_clip, copy_to_group(local.lora_a, g), local.lora_b)
        else:
            y = local(x) if isinstance(local, nn.Linear) else local(x, activation_clip)
        return gather_from_group(y, g, -1) if self.gather else y


class RowParallelLinear(nn.Module):
    """The rank's input slice of a linear (``local``, without its bias):
    the rank's slice of the input in (a whole input is sliced), the sum of
    the ranks' products out, then the bias (kept whole here)."""

    def __init__(self, local: nn.Module, mesh: Mesh, span: Tuple[int, int], in_features: int,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.local = local
        self.group = mesh.model_group
        self.lo, self.hi = span
        self.in_features, self.out_features = in_features, local.out_features
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(),
                                                           requires_grad=bias.requires_grad)
        if isinstance(_base(local), Int8Linear):  # K3's partial dots, scaled after the sum
            self.register_buffer("ones", torch.ones_like(_base(local).s), persistent=False)

    def _product(self, base: nn.Module, x, clip):
        """The whole product of ``base`` over the ranks, without a bias."""
        g = self.group
        if isinstance(base, W4A8Blocks):  # the w4a8 rule: the whole input
            return base(copy_to_group(gather_from_group(x, g, -1), g), clip)
        if isinstance(base, W8A8Linear):
            y = _RowW8A8.apply(_clip(x.float(), clip), base.q8a, base.s, g)
            return y.to(x.dtype)
        if isinstance(base, Int8Linear):
            return _RowInt8.apply(_clip(x.float(), clip), base.q, base.s, self.ones,
                                  g).to(x.dtype)
        if isinstance(base, CachedFpLinear):
            return reduce_from_group(cached_fp_mm(x, {"fp": base.fp}, clip), g)
        return reduce_from_group(F.linear(x, base.weight), g)

    def forward(self, x, activation_clip: Optional[float] = None):
        g = self.group
        if x.shape[-1] == self.in_features:  # a whole input: this rank's slice
            x = scatter_to_group(x, g, -1)
        local = self.local
        y = self._product(_base(local), x, activation_clip)
        if isinstance(local, LoRALinear):  # lora_b is whole: its gradient sums
            y = y + reduce_from_group(lora_delta(x, local.lora_a, copy_to_group(local.lora_b, g),
                                                 local.lora_s), g)
        return y if self.bias is None else y + self.bias


class _RowW8A8(torch.autograd.Function):
    """A row layer's w8a8 product over the ranks (fp32 x [..., K/tp] after
    the clip): per-token activation scales from the absmax over the WHOLE K
    (a max-all-reduce), the exact int32 partial dots summed, then scaled,
    as one rank computes it. Backward straight through on the rank's K
    slice: ``g @ (q8a * s)^T``."""

    @staticmethod
    def forward(ctx, xf, q8a, s, group):
        ctx.save_for_backward(q8a, s)
        amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
        xs = _div(amax.clamp_min(1e-6), 127.0)
        xq = torch.round(xf / xs).clamp(-128, 127).to(torch.int8)
        acc = int8_dot(xq.reshape(-1, xf.shape[-1]).contiguous(), q8a)
        acc = all_reduce_sum(acc, group).reshape(*xf.shape[:-1], -1)
        return acc.float() * xs * s

    @staticmethod
    def backward(ctx, g):
        q8a, s = ctx.saved_tensors
        return g @ (q8a.float() * s).T, None, None, None


class _RowInt8(torch.autograd.Function):
    """A row layer's int8 weight-only product (K3 at K/tp on fp32 x after
    the clip): the fp32 partial dots summed, then scaled. Backward
    ``(g * s) @ q^T`` on the rank's K slice (the weight dequantized)."""

    @staticmethod
    def forward(ctx, xf, q, s, ones, group):
        ctx.save_for_backward(q, s)
        part = int8_mm(xf, {"q": q, "s": ones})
        return all_reduce_sum(part, group) * s

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        return (g * s) @ q.float().T, None, None, None, None


class ReplicatedLinear(nn.Module):
    """A whole linear (``local``) inside a split region: its input and its
    parameters are read through ``copy_to_group``, since the ranks read
    its output in part (Pi-0's k and v under the rank's query heads), so
    their gradients sum the ranks' partial ones. The forward is the
    linear's own."""

    def __init__(self, local: nn.Module, mesh: Mesh):
        super().__init__()
        self.local = local
        self.group = mesh.model_group
        self.in_features, self.out_features = local.in_features, local.out_features

    def forward(self, x, activation_clip: Optional[float] = None):
        g = self.group
        x = copy_to_group(x, g)
        local = self.local
        if isinstance(local, LoRALinear):
            return local.product(x, activation_clip, copy_to_group(local.lora_a, g),
                                 copy_to_group(local.lora_b, g))
        if isinstance(local, nn.Linear):
            bias = None if local.bias is None else copy_to_group(local.bias, g)
            return F.linear(x, copy_to_group(local.weight, g), bias)
        return local(x, activation_clip)  # a quantized linear: no parameter


def _column_local(mod: nn.Module, mesh: Mesh, cols: Optional[Tuple[int, int]]):
    """The rank's output slice of ``mod`` (or, for a w4a8 base, its
    blocks, returning ``cols`` of the output or all of it)."""
    base = _base(mod)
    if isinstance(base, W4A8Linear):
        local = W4A8Blocks.from_linear(base, mesh, cols)
    else:
        lo, hi = cols if cols is not None else _span(base.out_features, mesh, "output")
        local = _local_linear(base, "out", lo, hi, keep_bias=True)
    if isinstance(mod, LoRALinear):
        b = mod.lora_b if cols is None else mod.lora_b[:, cols[0]:cols[1]]
        local = LoRALinear(local, mod.lora_a.detach(), b.detach().clone(), mod.lora_s)
    return local


def parallel_linear(mod: nn.Module, rule: str, mesh: Mesh) -> nn.Module:
    """The TP wrapper of linear ``mod`` under ``rule`` (``COLUMN``, ``ROW``
    or ``VOCAB``) for this rank of ``mesh``."""
    base = _base(mod)
    k, n = base.in_features, base.out_features
    if rule == COLUMN:
        cols = _span(n, mesh, "output")
        return ColumnParallelLinear(_column_local(mod, mesh, cols), mesh, k, cols[1] - cols[0])
    if rule == VOCAB:
        if isinstance(base, W4A8Linear):  # its blocks gather the whole vocabulary
            return ColumnParallelLinear(_column_local(mod, mesh, None), mesh, k, n)
        cols = _span(n, mesh, "vocabulary")
        return ColumnParallelLinear(_column_local(mod, mesh, cols), mesh, k, n, gather=True)
    if rule != ROW:
        raise ValueError(f"unknown TP rule {rule!r}")
    lo, hi = _span(k, mesh, "input")
    if isinstance(base, W4A8Linear):
        local = W4A8Blocks.from_linear(base, mesh)
    else:
        local = _local_linear(base, "in", lo, hi, keep_bias=False)
    if isinstance(mod, LoRALinear):
        local = LoRALinear(local, mod.lora_a[lo:hi].detach().clone(), mod.lora_b.detach(),
                           mod.lora_s)
    return RowParallelLinear(local, mesh, (lo, hi), k, getattr(base, "bias", None))


class VocabParallelEmbedding(nn.Module):
    """The rank's rows [lo, lo + V/tp) of a token table ``weight``."""

    def __init__(self, weight: torch.Tensor, lo: int, vocab: int, mesh: Mesh):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=weight.requires_grad)
        self.lo, self.vocab, self.group = lo, vocab, mesh.model_group

    @classmethod
    @torch.no_grad()
    def from_table(cls, table: torch.Tensor, mesh: Mesh) -> "VocabParallelEmbedding":
        lo, hi = _span(table.shape[0], mesh, "vocabulary")
        return cls(_cut(table.detach(), 0, lo, hi), lo, table.shape[0], mesh)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.lo
        weight = self.weight
        held = (local >= 0) & (local < weight.shape[0])
        rows = F.embedding(local.clamp(0, weight.shape[0] - 1), weight)
        return reduce_from_group(rows * held[..., None].to(rows.dtype), self.group)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ table.T`` over the whole vocabulary (a tied head)."""
        g = self.group
        return gather_from_group(copy_to_group(h, g) @ self.weight.t().to(h.dtype), g, -1)

    def extra_repr(self) -> str:
        return f"rows {self.lo}..{self.lo + self.weight.shape[0]} of {self.vocab}"


# ---------------------------------------------------------------------------
# The sharded model's tensors against the one-card model's
# ---------------------------------------------------------------------------

_WRAPPERS = (ColumnParallelLinear, RowParallelLinear, ReplicatedLinear, VocabParallelEmbedding)
_QUANT_TENSOR = {Int8Linear: "q", W8A8Linear: "q8a", CachedFpLinear: "fp"}


def _split_axes(local: nn.Module, column: bool) -> Dict[str, Optional[int]]:
    """{tensor name in a TP wrapper's ``local``: the axis it is split on
    over the model ranks, None where it is whole}. ``column`` for a column
    layer's output split, else a row layer's input split."""
    if isinstance(local, LoRALinear):
        out = {"lora_a": None if column else 0, "lora_b": 1 if column else None,
               "lora_s": None}
        return {**out, **{f"base.{k}": v for k, v in _split_axes(local.base, column).items()}}
    if isinstance(local, W4A8Blocks):
        return {"q4": 0, "s": 1}
    if isinstance(local, nn.Linear):
        return {"weight": 0 if column else 1, "bias": 0}
    for cls, name in _QUANT_TENSOR.items():  # [in, out] payloads, [out] scales
        if isinstance(local, cls):
            return {name: 1 if column else 0, "s": 0 if column else None, "bias": 0}
    if isinstance(local, W4A8Linear):  # whole under a rule (rule_axes)
        return {}
    raise TypeError(f"no TP layout of a {type(local).__name__}")


def state_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and persistent buffer of ``model`` by name, each
    once (a tied module under its first name)."""
    out = dict(model.named_parameters())
    for prefix, mod in model.named_modules():
        for name, b in mod.named_buffers(recurse=False):
            if name not in mod._non_persistent_buffers_set:
                out[f"{prefix}.{name}" if prefix else name] = b
    return out


def tp_layout(model: nn.Module, mesh: Mesh) -> Dict[str, Tuple[str, Optional[int], int]]:
    """{name of a tensor of the (TP-)sharded ``model``: (the name of the
    one-card model's tensor it is a slice of, the axis split over the model
    ranks or None, that axis's one-card length)}. A w4a8 scale's one-card
    length is N, its ranks' columns padded to NB * BN."""
    from blurr_tpu_torch.parallel.mesh import _SEPARATE_BIASES, rule_for

    tp = mesh.model
    out: Dict[str, Tuple[str, Optional[int], int]] = {}
    wrapped = {}
    for path, mod in model.named_modules():
        if isinstance(mod, _WRAPPERS) and not any(path.startswith(p + ".") for p in wrapped):
            wrapped[path] = mod
    tensors = state_tensors(model)
    for name, t in tensors.items():
        owner = next((p for p in wrapped if name.startswith(p + ".")), None)
        if owner is None:
            *head, leaf = name.split(".")
            cut = leaf in _SEPARATE_BIASES and rule_for(".".join(head + [_SEPARATE_BIASES[leaf]]))
            out[name] = (name, 0, t.shape[0] * tp) if cut else (name, None, 0)
            continue
        mod, rest = wrapped[owner], name[len(owner) + 1:]
        if isinstance(mod, VocabParallelEmbedding):
            out[name] = (owner, 0, mod.vocab)
            continue
        if rest == "bias":  # a row layer's, whole
            base_bias = isinstance(mod.local, LoRALinear)
            out[name] = (f"{owner}.base.bias" if base_bias else f"{owner}.bias", None, 0)
            continue
        local_name = rest[len("local."):]
        axis = (None if isinstance(mod, ReplicatedLinear)
                else _split_axes(mod.local, isinstance(mod, ColumnParallelLinear))[local_name])
        base = _base(mod.local)
        if isinstance(base, W4A8Blocks) and base.cols is None and local_name == "lora_b":
            axis = None  # the blocks gather the whole output: the factor is whole
        whole = t.shape[axis] * tp if axis is not None else 0
        if isinstance(base, W4A8Blocks) and local_name.split(".")[-1] == "s" and axis == 1:
            whole = base.n
        out[name] = (f"{owner}.{local_name}", axis, whole)
    return out


def rule_axes(model: nn.Module) -> Dict[str, int]:
    """{tensor name: the axis its TP rule splits} of a model no TP wrapper
    holds (``parallel/mesh.py:rule_for``; the axes ``tp_layout`` gives once
    sharded), biases left out: JAX keeps them whole. What a model axis of
    one still claims from FSDP, as a mesh axis of size one does in JAX's
    ``_augment_fsdp``."""
    from blurr_tpu_torch.parallel.mesh import rule_for

    out: Dict[str, int] = {}
    done = []
    for path, mod in model.named_modules():
        rule = rule_for(path)
        if rule is None or any(path.startswith(p + ".") for p in done) or not is_linear(mod):
            continue
        done.append(path)
        base = _base(mod)
        axes = _split_axes(mod, rule != ROW)
        if isinstance(base, W4A8Linear):  # the w4a8 rule: the blocks and their scales
            prefix = "base." if base is not mod else ""
            axes = {**axes, f"{prefix}q4": 0, f"{prefix}s": 1}
        out.update({f"{path}.{k}": v for k, v in axes.items()
                    if v is not None and not k.endswith("bias")})
    for path, p in model.named_parameters():
        if path.split(".")[-1] == "embed_tokens":
            out[path] = 0
    return out


def one_card_kinds(model: nn.Module) -> Dict[str, str]:
    """{one-card module name: linear kind} (``models/pi0/checkpoint.py``'s
    ``linear_kinds`` of the one-card model) of a TP-sharded ``model``: a
    wrapper's ``local`` stands at the wrapper's name, a rank's w4a8 blocks
    as ``w4a8``."""
    from blurr_tpu_torch.models.pi0.checkpoint import _kind

    def kind(mod):
        if isinstance(mod, W4A8Blocks):
            return "w4a8"
        if isinstance(mod, LoRALinear):
            return "lora/" + kind(mod.base)
        return _kind(mod)

    out = {}
    for name, mod in model.named_modules():
        if any(name.startswith(k + ".") for k in out):
            continue
        if isinstance(mod, (ColumnParallelLinear, RowParallelLinear, ReplicatedLinear)):
            k = kind(mod.local)
            if k != "fp":
                out[name] = k
        elif isinstance(mod, (LoRALinear, *QUANT_MODULES)):
            out[name] = kind(mod)
    return out
