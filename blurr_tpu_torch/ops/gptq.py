"""GPTQ: calibration-based error-feedback rounding for the w4a8 tier.

Counterpart of ``blurr_tpu/ops/gptq.py`` (``hessian_from_inputs``,
``_mse_group_scale``, ``_quantize_group``, ``_gptq_levels``,
``gptq_quantize_weight``, ``layer_output_mse``). The data-free MSE-clip
search (``ops/quant.py:quantize_weight_w4a8``) minimizes each cell's weight
reconstruction error; GPTQ (Frantar et al., 2022, arXiv:2210.17323)
minimizes the layer output error ||X (W - Wq)||^2 for calibration inputs X.
The rows of W [K, N] (input dims) are quantized in order, and each row's
rounding error is carried into the rows not yet quantized through the upper
Cholesky factor U of H^-1 = (X^T X + damp I)^-1. The schedule is blocked with
one block per scale group: the rows of a group are walked one at a time with
feedback inside the group, then one [rest, gs] x [gs, N] product carries the
group's residual into every later row.

The output is ``quantize_weight_w4a8``'s ``{"q4", "s"}`` (block-major packed
int4, fp32 [G, N] group scales), so ``W4A8Linear`` and the int4 kernel K2
serve a GPTQ weight unchanged. With H = I nothing is fed back, and the bytes
are those of the data-free path (``tests/test_torch_gptq.py``).

JAX's safeguards are kept: H^-1 through Cholesky, symmetrized and jittered;
the diagonal of H^-1 in place of U where the second Cholesky fails; dead
inputs (a zero diagonal of H) given a unit diagonal. In JAX this is XLA, not
a Pallas kernel; here it is ``torch.linalg`` and a plain loop over each
group's rows. ``_gptq_levels`` also takes a leading batch axis (several
layers, or several weights of one input concatenated along N: every column
is quantized independently), so a mixture's 18 layers walk their rows once.
"""

from __future__ import annotations

import torch

from blurr_tpu_torch.ops.int4_matmul import (
    pack_int4,
    pick_block_layout,
    pick_group_size,
    to_block_major,
)
from blurr_tpu_torch.ops.quant import _W4A8_CLIP_GRID, _div, _w4a8_deq


def hessian_from_inputs(x: torch.Tensor, damp: float = 0.01) -> torch.Tensor:
    """X [..., T, K] (zero rows for padded tokens add nothing) -> the damped
    fp32 Hessian 2 X^T X / T + damp * mean(diag) * I [..., K, K]. Dead inputs
    (a zero diagonal) get a unit diagonal, so the Cholesky stays positive
    definite; their weight rows then quantize without feedback."""
    xf = x.float()
    h = (2.0 / max(x.shape[-2], 1)) * (xf.mT @ xf)
    diag = h.diagonal(dim1=-2, dim2=-1)
    dead = diag == 0.0
    h = h + torch.diag_embed(dead.float())
    mean_diag = torch.where(dead, 0.0, diag).mean(dim=-1)
    eye = torch.eye(h.shape[-1], dtype=torch.float32, device=h.device)
    return h + damp * mean_diag.clamp_min(1e-8)[..., None, None] * eye


def _mse_group_scale(wg: torch.Tensor, grid=_W4A8_CLIP_GRID) -> torch.Tensor:
    """The per-out-channel int4 scale [..., N] of one group's current
    (compensated) rows [..., gs, N]: the data-free path's clip-grid MSE
    search."""
    amax = wg.abs().amax(dim=-2).clamp_min(1e-6)
    scale = _div(amax, 7.0)
    q = torch.round(wg / scale[..., None, :]).clamp(-8, 7)
    best = ((q * scale[..., None, :] - wg) ** 2).sum(dim=-2)
    for c in grid[1:]:
        s_c = amax * (c / 7.0)
        q_c = torch.round(wg / s_c[..., None, :]).clamp(-8, 7)
        e_c = ((q_c * s_c[..., None, :] - wg) ** 2).sum(dim=-2)
        take = e_c < best
        best = torch.where(take, e_c, best)
        scale = torch.where(take, s_c, scale)
    return scale


def _quantize_group(wg: torch.Tensor, u_gg: torch.Tensor):
    """The error-feedback walk over one group's rows. wg [..., gs, N]: the
    current rows; u_gg [..., gs, gs]: the group's diagonal block of U.
    Returns (levels [..., gs, N], scale [..., N], err [..., gs, N]), err the
    normalized residuals that later rows and groups subtract through U."""
    gs = wg.shape[-2]
    scale = _mse_group_scale(wg)
    w = wg.clone()
    q = torch.zeros_like(wg)
    err = torch.zeros_like(wg)
    diag = u_gg.diagonal(dim1=-2, dim2=-1)
    for i in range(gs):
        w_i = w[..., i, :]
        q_i = torch.round(w_i / scale).clamp(-8, 7)
        e_i = (w_i - q_i * scale) / diag[..., i, None]
        # into the rows of this group not yet quantized
        w[..., i + 1:, :] -= u_gg[..., i, i + 1:, None] * e_i[..., None, :]
        q[..., i, :] = q_i
        err[..., i, :] = e_i
    return q, scale, err


def _upper_factor(hessian: torch.Tensor) -> torch.Tensor:
    """U with H^-1 = U^T U (torch-GPTQ's cholesky(cholesky_inverse(
    cholesky(H)), upper=True)): H^-1 through the Cholesky solve, symmetrized
    and jittered (an ill-conditioned fp32 inverse drifts off positive
    definite); where the second Cholesky fails, the diagonal of H^-1 (no
    feedback: plain rounding) in place of U."""
    k = hessian.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=hessian.device)
    low, info = torch.linalg.cholesky_ex(hessian.float())
    low = torch.where((info > 0)[..., None, None], torch.nan, low)  # JAX's NaN on failure
    hinv = torch.cholesky_solve(eye.expand_as(low), low)
    hinv = 0.5 * (hinv + hinv.mT)
    hinv = hinv + 1e-5 * hinv.diagonal(dim1=-2, dim2=-1).mean(dim=-1)[..., None, None] * eye
    u, info = torch.linalg.cholesky_ex(hinv, upper=True)
    bad = (info > 0) | torch.isnan(u).flatten(-2).any(dim=-1)
    u_diag = torch.diag_embed(hinv.diagonal(dim1=-2, dim2=-1).clamp_min(1e-12).sqrt())
    return torch.where(bad[..., None, None], u_diag, u)


def _gptq_levels(w: torch.Tensor, hessian: torch.Tensor, group_size: int):
    """fp weight [..., K, N] + Hessian [..., K, K] -> (int levels [..., K, N]
    fp32, scales [..., G, N]): the groups in order, each walked row by row,
    then its residual carried into all later rows by one product."""
    k, n = w.shape[-2:]
    if k % group_size:
        raise ValueError(f"K={k} is not a multiple of the group size {group_size}")
    u = _upper_factor(hessian)
    wf = w.float().clone()
    q_parts, s_parts = [], []
    for g0 in range(0, k, group_size):
        g1 = g0 + group_size
        q_g, s_g, err = _quantize_group(wf[..., g0:g1, :], u[..., g0:g1, g0:g1])
        q_parts.append(q_g)
        s_parts.append(s_g)
        if g1 < k:
            wf[..., g1:, :] -= u[..., g0:g1, g1:].mT @ err
    return torch.cat(q_parts, dim=-2), torch.stack(s_parts, dim=-2)


def pack_levels(q: torch.Tensor, scale: torch.Tensor) -> dict:
    """int levels [K, N] + scales [G, N] -> ``{"q4", "s"}`` in
    ``quantize_weight_w4a8``'s layout (N zero-padded to the block layout)."""
    n = q.shape[-1]
    q = q.to(torch.int8)
    bn, n_pad = pick_block_layout(n)
    if n_pad != n:
        q = torch.nn.functional.pad(q, (0, n_pad - n))
    return {"q4": to_block_major(pack_int4(q), bn), "s": scale.float().contiguous()}


def gptq_quantize_weight(w: torch.Tensor, hessian: torch.Tensor,
                         group_size: int = 512) -> dict:
    """[K, N] + calibration Hessian [K, K] -> w4a8 ``{"q4", "s"}``, the format
    of the data-free ``quantize_weight_w4a8`` (the JAX function's ``shards``
    packing for tensor parallelism is not ported)."""
    if w.dim() != 2 or w.shape[0] % 2:
        raise ValueError(f"w4a8 takes a 2-D weight with an even K, got {tuple(w.shape)}")
    gs = pick_group_size(w.shape[0], group_size)
    return pack_levels(*_gptq_levels(w, hessian, gs))


def layer_output_mse(x: torch.Tensor, w: torch.Tensor, wq: dict) -> torch.Tensor:
    """||X W - X deq(Wq)||^2 / T, the quantity GPTQ minimizes: held-out inputs
    score GPTQ against the data-free rounding."""
    deq = _w4a8_deq(wq["q4"], wq["s"], w.shape[0])
    d = x.float() @ (w.float() - deq)
    return (d * d).sum() / max(x.shape[0], 1)
