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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.ops.lora import LoRALinear
from blurr_tpu_torch.ops.quant import (
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
    all_gather,
    all_reduce_max,
    all_reduce_sum,
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
        y = all_gather(y, self.group, -1)[..., :self.n]
        return y if self.cols is None else y[..., self.cols[0]:self.cols[1]]

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
        local = self.local
        y = local(x) if type(local) is nn.Linear else local(x, activation_clip)
        return all_gather(y, self.group, -1) if self.gather else y


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
            return base(all_gather(x, g, -1), clip)
        if isinstance(base, W8A8Linear):
            xf = _clip(x.float(), clip)
            amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), g)
            xs = _div(amax.clamp_min(1e-6), 127.0)
            xq = torch.round(xf / xs).clamp(-128, 127).to(torch.int8)
            acc = int8_dot(xq.reshape(-1, x.shape[-1]).contiguous(), base.q8a)
            acc = all_reduce_sum(acc, g).reshape(*x.shape[:-1], -1)
            return (acc.float() * xs * base.s).to(x.dtype)
        if isinstance(base, Int8Linear):
            part = int8_mm(x.float(), {"q": base.q, "s": self.ones}, clip)
            return (all_reduce_sum(part, g) * base.s).to(x.dtype)
        if isinstance(base, CachedFpLinear):
            return all_reduce_sum(cached_fp_mm(x, {"fp": base.fp}, clip), g)
        return all_reduce_sum(F.linear(x, base.weight), g)

    def forward(self, x, activation_clip: Optional[float] = None):
        if x.shape[-1] == self.in_features:  # a whole input: this rank's slice
            x = x[..., self.lo:self.hi]
        local = self.local
        y = self._product(_base(local), x, activation_clip)
        if isinstance(local, LoRALinear):
            y = y + all_reduce_sum(lora_delta(x, local.lora_a, local.lora_b, local.lora_s),
                                   self.group)
        return y if self.bias is None else y + self.bias


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
        held = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(local.clamp(0, self.weight.shape[0] - 1), self.weight)
        return all_reduce_sum(rows * held[..., None].to(rows.dtype), self.group)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ table.T`` over the whole vocabulary (a tied head)."""
        return all_gather(h @ self.weight.t().to(h.dtype), self.group, -1)

    def extra_repr(self) -> str:
        return f"rows {self.lo}..{self.lo + self.weight.shape[0]} of {self.vocab}"
