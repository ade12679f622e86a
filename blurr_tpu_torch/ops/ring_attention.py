"""Ring attention: sequence-parallel attention whose K/V blocks travel round
the ranks instead of being gathered.

Counterpart of ``blurr_tpu/ops/ring_attention.py``. JAX runs an einsum
recurrence under ``shard_map``, rotating the K/V blocks over the 'seq'
axis with ``ppermute``; here each rank is a process of its own and calls
``ring_attention`` on its own contiguous slice of the tokens. The blocks
rotate with ``parallel/mesh.py:rotate_to_prev`` (``dist.batch_isend_irecv``),
whose backward is the reverse rotation, so autograd differentiates the
whole recurrence.

JAX's ``_local_ring``, step for step: fp32 (m, l, o) accumulators; the
resident block folded first, then n - 1 rotations (no last rotation back
home); ``k_valid`` travelling with its block; causal positions from the
visiting block's original owner; exact zeros for masked slots and 0 for a
query row that sees no key; GQA grouping; the Gemma tanh clamp on by
default. The result equals ``ops/attention.py:grouped_attention`` with the
causal / padding mask on the rows that see a key.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from blurr_tpu_torch.ops.attention import DEFAULT_SOFTCLAMP
from blurr_tpu_torch.parallel.mesh import (
    gather_from_group,
    rotate_to_prev,
    rotated,
    scatter_to_group,
)

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def _group_of(mesh_or_group):
    """The process group the ring runs over: a ``Mesh``'s seq group, or the
    group itself (None: one rank)."""
    return getattr(mesh_or_group, "seq_group", mesh_or_group)


def ring_attention(
    q: torch.Tensor,  # [B, NH, S/n, D], this rank's queries
    k: torch.Tensor,  # [B, KVH, S/n, D], this rank's keys
    v: torch.Tensor,  # [B, KVH, S/n, D]
    mesh_or_group,
    causal: bool = True,
    k_valid: Optional[torch.Tensor] = None,  # bool [B, S/n], this rank's keys
    softclamp: Optional[float] = DEFAULT_SOFTCLAMP,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """This rank's rows of GQA attention over every rank's keys, [B, NH,
    S/n, D] in ``q.dtype``. The ranks of the group (a ``Mesh``'s seq
    group, or a process group) hold the token axis in rank order."""
    group = _group_of(mesh_or_group)
    n = 1 if group is None else dist.get_world_size(group)
    my = 0 if group is None else dist.get_rank(group)
    b, nh, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if nh % kvh:
        raise ValueError(f"{nh} query heads do not group over {kvh} KV heads")
    g = nh // kvh
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, kvh, g, sq, d).float()
    q_pos = my * sq + torch.arange(sq, device=q.device)
    kval = (torch.ones((b, skv), dtype=torch.bool, device=q.device) if k_valid is None
            else k_valid.bool())

    o = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    k_c, v_c = k, v
    for t in range(n):
        if t:
            k_c, v_c = rotate_to_prev((k_c, v_c), group)
            if k_valid is not None:  # a mask travels with its block
                kval = rotated([kval.to(torch.uint8)], group, 1)[0].bool()
        j = (my + t) % n  # the visiting block's original owner
        logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k_c.float()) * scale
        if softclamp is not None:
            logits = torch.tanh(logits / softclamp) * softclamp
        keep = kval[:, None, None, None, :]
        if causal:
            k_pos = j * skv + torch.arange(skv, device=q.device)
            keep = keep & (q_pos[:, None] >= k_pos[None, :])
        logits = torch.where(keep, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(keep, p, 0.0)  # exact zeros for masked slots
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, v_c.float())
        m = m_new
    out = torch.where(l[..., None] > 0, o / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.reshape(b, nh, sq, d).to(q.dtype)


def ring_attention_whole(q, k, v, mesh_or_group, causal: bool = True,
                         k_valid: Optional[torch.Tensor] = None,
                         softclamp: Optional[float] = DEFAULT_SOFTCLAMP,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``ring_attention`` on whole tensors (the same on every rank, [B, NH,
    S, D]; ``k_valid`` [B, S]): each rank takes its slice of the tokens and
    every rank gets the whole output, the gradients whole too (for tests,
    as JAX's ``ring_attention`` takes and gives global arrays)."""
    group = _group_of(mesh_or_group)
    q, k, v = (scatter_to_group(t, group, 2) for t in (q, k, v))
    if k_valid is not None and group is not None:
        w = k_valid.shape[1] // dist.get_world_size(group)
        k_valid = k_valid.narrow(1, dist.get_rank(group) * w, w)
    out = ring_attention(q, k, v, group, causal, k_valid, softclamp, scale)
    return gather_from_group(out, group, 2)
