"""The LLaMA / Qwen2 decoder of the OpenVLA family, with greedy and Jacobi
decoding.

Counterpart of ``blurr_tpu/models/openvla/llama.py``. LLaMA-2-7B: 32
layers, width 4096, 32 heads of 128 (GQA also taken), SwiGLU 11008, LLaMA's
RMSNorm (normalize in fp32, cast down, then scale) and fp32 RoPE. The
Qwen2 knobs of MiniVLA's Qwen2.5-0.5B are ``qkv_bias`` (q, k and v biases,
added after the product) and ``tie_word_embeddings`` (the logits read the
embedding's transpose).

Linears are ``nn.Linear``s, swapped in place for ``ops.quant``'s
``W8A8Linear`` / ``W4A8Linear`` by ``quantize_llama_w8a8`` /
``quantize_llama_w4a8`` (a tied head is materialized quantized as
``lm_head``; the fp embedding stays for the gather), so every w4a8 product,
the head's included, goes through the int4 kernel ``ops.int4_matmul``.
``Llama(quant_init=...)`` builds those modules directly, their int8 bytes
drawn on the device by ``init_params``, so a 7B never exists in bf16 (JAX
``init_llama_params_w8a8`` / ``init_llama_params_w4a8``).

Attention is the plain ``ops.attention.grouped_attention`` without the soft
clamp, as JAX runs it in XLA (no Pallas kernel): the flash kernel K1 is
built for Gemma's 8:1 heads of 256 with a clamp. The KV cache is a pair of
[L, B, KVH, max_len, D] buffers written in place at a host offset, so a
decode step reads nothing back from the device. ``greedy_generate`` keeps
the tokens on the device until the caller fetches them;
``greedy_generate_jacobi`` reads one flag back per sweep. Not ported:
``relayout_qkv_for_jacobi`` (a TPU layout fix).

Training (JAX ``forward(..., remat=)``) runs ``Llama.forward`` with
``cache=None``: each layer attends over its own fresh K and V, so no layer
writes into a buffer another layer saved for the backward (the views of
one cache tensor share its version counter, and autograd refuses a saved
view that a later layer's in-place write has touched). ``remat`` wraps each
layer in ``torch.utils.checkpoint.checkpoint`` (non-reentrant), which
recomputes its activations in the backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from blurr_tpu_torch.ops.activations import silu
from blurr_tpu_torch.ops.embeddings import embedding, table_logits
from blurr_tpu_torch.ops.attention import grouped_attention, merge_heads, split_heads
from blurr_tpu_torch.ops.int4_matmul import pick_block_layout, pick_group_size
from blurr_tpu_torch.ops.quant import (
    W4A8Linear,
    W8A8Linear,
    _swap,
    quantize_weight_w4a8,
    quantize_weight_w8a8,
)
from blurr_tpu_torch.ops.rotary import apply_rope, rope_cos_sin

# (k, v), each [L, B, KVH, max_len, D]
Cache = Tuple[torch.Tensor, torch.Tensor]
QUANT_INITS = ("w8a8", "w4a8")
# the linears of a layer, in JAX's order (q_w ... down_w)
LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class LlamaSpec:
    vocab_size: int = 32064
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    eps: float = 1e-5
    pad_token_id: int = 32000
    # Qwen2 (MiniVLA's Qwen2.5-0.5B): q/k/v biases, head tied to the embedding
    qkv_bias: bool = False
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """LLaMA's RMSNorm: normalize in fp32, cast down, THEN scale by w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def materialize(root: nn.Module, device) -> None:
    """Give every parameter of ``root`` still on the meta device
    uninitialized storage on ``device`` (no default initialization runs)."""
    for mod in root.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if p.is_meta:
                setattr(mod, name, nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device=device)))


def _empty_quantized(mode: str, k: int, n: int, device) -> nn.Module:
    """A quantized linear [k -> n] of ``mode`` with uninitialized buffers on
    ``device``, in the JAX package's layouts (``init_params`` draws them)."""
    if mode == "w8a8":
        return W8A8Linear(torch.empty(k, n, dtype=torch.int8, device=device),
                          torch.empty(n, device=device))
    bn, n_pad = pick_block_layout(n)
    groups = k // pick_group_size(k)
    return W4A8Linear(torch.empty(n_pad // bn, k // 2, bn, dtype=torch.int8, device=device),
                      torch.empty(groups, n, device=device))


class LlamaLayer(nn.Module):
    def __init__(self, spec: LlamaSpec, *, device, dtype):
        super().__init__()
        h, inter = spec.hidden_size, spec.intermediate_size
        q_out, kv_out = spec.num_heads * spec.head_dim, spec.num_kv_heads * spec.head_dim
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.input_norm = nn.Parameter(torch.empty(h, **kw))
        self.post_norm = nn.Parameter(torch.empty(h, **kw))
        self.q_proj = nn.Linear(h, q_out, bias=False, **kw)
        self.k_proj = nn.Linear(h, kv_out, bias=False, **kw)
        self.v_proj = nn.Linear(h, kv_out, bias=False, **kw)
        self.o_proj = nn.Linear(q_out, h, bias=False, **kw)
        self.gate_proj = nn.Linear(h, inter, bias=False, **kw)
        self.up_proj = nn.Linear(h, inter, bias=False, **kw)
        self.down_proj = nn.Linear(inter, h, bias=False, **kw)
        if spec.qkv_bias:
            self.q_b = nn.Parameter(torch.empty(q_out, **kw))
            self.k_b = nn.Parameter(torch.empty(kv_out, **kw))
            self.v_b = nn.Parameter(torch.empty(kv_out, **kw))

    def forward(self, h, cos, sin, mask, k_buf=None, v_buf=None, offset: int = 0
                ) -> torch.Tensor:
        """One layer over ``h`` [B, S, H]. With buffers, K and V are written
        into them at ``offset`` in place and attention reads the buffers;
        without (training), it reads this layer's own K and V."""
        s = self.spec
        hd = s.head_dim
        x = llama_rms_norm(h, self.input_norm, s.eps)
        qh, kh, vh = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if s.qkv_bias:
            qh, kh, vh = qh + self.q_b, kh + self.k_b, vh + self.v_b
        # the head counts from the widths: this rank's heads under TP
        q = apply_rope(split_heads(qh, qh.shape[-1] // hd, hd), cos, sin)
        k = apply_rope(split_heads(kh, kh.shape[-1] // hd, hd), cos, sin)
        v = split_heads(vh, kh.shape[-1] // hd, hd)
        if k_buf is not None:
            n = h.shape[1]
            k_buf[:, :, offset:offset + n] = k
            v_buf[:, :, offset:offset + n] = v
            k, v = k_buf, v_buf
        attn = grouped_attention(q, k, v, mask, softclamp=None)
        h = h + self.o_proj(merge_heads(attn))
        x = llama_rms_norm(h, self.post_norm, s.eps)
        return h + self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class Llama(nn.Module):
    """The decoder on ``device`` in ``dtype``. ``quant_init`` "w8a8" or
    "w4a8" builds every layer linear and the head (a tied spec gets one too)
    as that quantized module, uninitialized, in place of the fp weights."""

    def __init__(self, spec: LlamaSpec, *, device, dtype, quant_init: Optional[str] = None):
        super().__init__()
        if quant_init not in (None, *QUANT_INITS):
            raise ValueError(f"quant_init {quant_init!r}: expected None, 'w8a8' or 'w4a8'")
        self.spec = s = spec
        kw = dict(device="meta", dtype=dtype)
        h = s.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(s.vocab_size, h, **kw))
        self.layers = nn.ModuleList(LlamaLayer(s, **kw) for _ in range(s.num_layers))
        self.final_norm = nn.Parameter(torch.empty(h, **kw))
        self.lm_head = None if s.tie_word_embeddings else nn.Linear(h, s.vocab_size, bias=False, **kw)
        if quant_init is not None:
            for layer in self.layers:
                for name in LAYER_LINEARS:
                    lin = getattr(layer, name)
                    setattr(layer, name, _empty_quantized(
                        quant_init, lin.in_features, lin.out_features, device))
            self.lm_head = _empty_quantized(quant_init, h, s.vocab_size, device)
        materialize(self, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llama":
        """Random weights drawn in place from ``generator`` (on the weights'
        device), with JAX's distributions: dense weights and the embedding
        N(0, 1/fan_in), norms 1, biases 0; quantized modules get uniform
        random int8 bytes (random nibble pairs for w4a8) and the constant
        scale fan_in**-0.5 / 127 (w8a8) or / 7 (w4a8)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features**-0.5, generator=generator)
            elif isinstance(mod, W8A8Linear):
                mod.q8a.random_(-127, 128, generator=generator)
                mod.s.fill_(mod.in_features**-0.5 / 127.0)
            elif isinstance(mod, W4A8Linear):
                mod.q4.random_(-128, 128, generator=generator)
                mod.s.fill_(mod.in_features**-0.5 / 7.0)
            elif isinstance(mod, LlamaLayer):
                mod.input_norm.fill_(1.0)
                mod.post_norm.fill_(1.0)
                for name in ("q_b", "k_b", "v_b"):
                    if hasattr(mod, name):
                        getattr(mod, name).zero_()
        self.embed_tokens.normal_(0.0, self.spec.hidden_size**-0.5, generator=generator)
        self.final_norm.fill_(1.0)
        return self

    def forward(self, embeds: torch.Tensor, position_ids: torch.Tensor, mask: torch.Tensor,
                cache: Optional[Cache], cache_offset: int = 0, remat: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """One forward over S tokens ([B, S, H]) at positions [B, S], the
        mask bool [B, S, max_len] over the cache buffer; each layer writes
        its K/V at ``cache_offset`` in place. Returns (hidden [B, S, H], cache).

        ``cache`` None is the training route (the module docstring): the
        mask is [B, S, S] over the S tokens themselves, and ``remat``
        recomputes each layer in the backward."""
        s = self.spec
        n = embeds.shape[1]
        cos, sin = rope_cos_sin(position_ids, s.head_dim, s.rope_theta)
        h = embeds
        if cache is None:
            for layer in self.layers:
                if remat:
                    h = checkpoint(layer, h, cos, sin, mask, use_reentrant=False)
                else:
                    h = layer(h, cos, sin, mask)
            return h, None
        if remat:
            raise ValueError("remat is for the training route (cache=None)")
        if cache_offset + n > cache[0].shape[3]:
            raise ValueError(f"{n} tokens at offset {cache_offset} overflow a cache of "
                             f"{cache[0].shape[3]}")
        for i, layer in enumerate(self.layers):
            h = layer(h, cos, sin, mask, cache[0][i], cache[1][i], cache_offset)
        return h, cache

    def final_hidden(self, h: torch.Tensor) -> torch.Tensor:
        return llama_rms_norm(h, self.final_norm, self.spec.eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        hf = self.final_hidden(h)
        if self.lm_head is not None:
            return self.lm_head(hf)
        return table_logits(hf, self.embed_tokens)  # tied (Qwen2-0.5B)

    def embed(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        return embedding(tokens, self.embed_tokens).to(dtype)

    @property
    def kv_heads(self) -> int:
        """The KV heads this model holds: ``num_kv_heads``, or this rank's
        share of them under tensor parallelism."""
        return self.layers[0].k_proj.out_features // self.spec.head_dim


def alloc_cache(spec: LlamaSpec, batch: int, max_len: int, dtype, device,
                kv_heads: Optional[int] = None) -> Cache:
    """A zeroed (k, v) pair of [L, B, KVH, max_len, D]; ``kv_heads`` (a
    rank's share under TP) defaults to the spec's."""
    kvh = spec.num_kv_heads if kv_heads is None else kv_heads
    shape = (spec.num_layers, batch, kvh, max_len, spec.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Quantizers (in place)
# ---------------------------------------------------------------------------


def _quantize_head(llama: Llama, from_linear, quantize) -> None:
    """An fp head goes quantized; a tied one is materialized quantized from
    the embedding's transpose (the fp embedding stays for the gather): the
    head is the largest weight a decode step reads."""
    if isinstance(llama.lm_head, nn.Linear):
        llama.lm_head = from_linear(llama.lm_head)
    elif llama.lm_head is None:
        _materialize_tied_head(llama, quantize)


def _materialize_tied_head(llama: Llama, quantize) -> None:
    llama.lm_head = quantize(llama.embed_tokens.detach().t())


def _quantize_llama(llama: Llama, from_linear, quantize, quantize_lm_head: bool) -> Llama:
    """Each linear kind over every layer in turn, the smallest kinds first
    (q, k, v, o, then gate, up, down for LLaMA-2-7B: the order JAX's
    memory-bounded quantizer sorts them in), then the head. Each fp weight
    goes with the module it replaces, so by the larger kinds the smaller
    ones' freed bytes cover their quantization transients (OpenVLA-7B w4a8
    on an H100: 336 MB above the start, 805 MB layer by layer)."""
    first = llama.layers[0]
    size = lambda a: getattr(first, a).in_features * getattr(first, a).out_features
    for attr in sorted(LAYER_LINEARS, key=size):
        for layer in llama.layers:
            _swap(layer, attr, from_linear)
    if quantize_lm_head:
        _quantize_head(llama, from_linear, quantize)
    return llama


@torch.no_grad()
def quantize_llama_w8a8(llama: Llama, quantize_lm_head: bool = True) -> Llama:
    """Swap every layer linear (and the head) for a ``W8A8Linear``; the
    embedding stays fp."""
    return _quantize_llama(llama, W8A8Linear.from_linear,
                           lambda w: W8A8Linear(**quantize_weight_w8a8(w)), quantize_lm_head)


@torch.no_grad()
def quantize_llama_w4a8(llama: Llama, quantize_lm_head: bool = True) -> Llama:
    """Swap every layer linear (and the head) for a ``W4A8Linear`` with
    512-row groups where K allows (``pick_group_size``)."""
    return _quantize_llama(llama, W4A8Linear.from_linear,
                           lambda w: W4A8Linear(**quantize_weight_w4a8(w)), quantize_lm_head)


def quantize_llama_streaming(llama: Llama, mode: str, quantize_lm_head: bool = True) -> Llama:
    """JAX's name for the quantizers above, by ``mode``: its streaming
    form exists because JAX's trees are immutable; the port's quantizers
    already free each fp weight as they go."""
    if mode not in QUANT_INITS:
        raise ValueError(f"mode {mode!r}: expected one of {QUANT_INITS}")
    return (quantize_llama_w8a8 if mode == "w8a8" else quantize_llama_w4a8)(llama, quantize_lm_head)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def causal_prefill_mask(attn_valid: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, S] validity -> bool [B, S, max_len]: row i sees the valid columns
    j <= i."""
    b, s = attn_valid.shape
    dev = attn_valid.device
    causal = (torch.arange(max_len, device=dev)[None, None, :]
              <= torch.arange(s, device=dev)[None, :, None])
    valid = F.pad(attn_valid.bool(), (0, max_len - s))[:, None, :]
    return causal & valid


def _prefill(llama: Llama, embeds, attn_valid, max_len: int):
    """The prompt's forward and its first token: (first token [B], cache,
    prompt-column validity [B, 1, max_len], valid lengths [B], the first
    token's logits [B, V])."""
    b, s, _ = embeds.shape
    dev = embeds.device
    cache = alloc_cache(llama.spec, b, max_len, embeds.dtype, dev, llama.kv_heads)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    h, cache = llama(embeds, pos, causal_prefill_mask(attn_valid, max_len), cache, 0)
    n_valid = attn_valid.long().sum(-1)
    # the last VALID position of each row (h[:, -1] would read a pad column)
    h_last = h.gather(1, (n_valid - 1)[:, None, None].expand(b, 1, h.shape[2]))
    first = llama.logits(h_last)[:, -1]
    # prompt columns keep their validity through decode; generated columns
    # become valid as they are written
    valid_cols = F.pad(attn_valid.bool(), (0, max_len - s), value=True)[:, None, :]
    return first.argmax(-1), cache, valid_cols, n_valid, first


@torch.no_grad()
def greedy_generate(llama: Llama, prompt_embeds: torch.Tensor, attn_valid: torch.Tensor,
                    num_new_tokens: int, max_len: Optional[int] = None,
                    return_logits: bool = False):
    """Greedy decode of ``num_new_tokens`` tokens after a right-padded
    prompt ([B, S, H], validity [B, S]): the prefill, then single-token
    steps. Cache writes land at column S + i for every row, but RoPE
    positions are per row (token i at n_valid + i) and the pad columns stay
    masked, so a padded row decodes as it would alone. Returns the tokens
    [B, n] on the device (and, with ``return_logits``, each step's logits
    [B, n, V]); nothing is read back."""
    b, s, _ = prompt_embeds.shape
    max_len = max_len or (s + num_new_tokens)
    tok, cache, valid_cols, n_valid, lg = _prefill(llama, prompt_embeds, attn_valid, max_len)
    cols = torch.arange(max_len, device=prompt_embeds.device)
    toks: List[torch.Tensor] = [tok]
    logits = [lg]
    for i in range(num_new_tokens - 1):
        offset = s + i
        mask = (cols <= offset)[None, None, :] & valid_cols
        h, cache = llama(llama.embed(tok[:, None], prompt_embeds.dtype),
                         (n_valid + i)[:, None], mask, cache, offset)
        lg = llama.logits(h[:, -1])
        tok = lg.argmax(-1)
        toks.append(tok)
        logits.append(lg)
    out = torch.stack(toks, 1)
    return (out, torch.stack(logits, 1)) if return_logits else out


@torch.no_grad()
def greedy_generate_jacobi(llama: Llama, prompt_embeds: torch.Tensor,
                           attn_valid: torch.Tensor, num_new_tokens: int,
                           max_len: Optional[int] = None, return_iters: bool = False,
                           init_guess=None, num_iters: Optional[int] = None,
                           return_logits: bool = False):
    """Greedy decode by Jacobi fixed-point iteration: guess the whole
    continuation, verify every position in ONE multi-token forward, repeat
    until the guess is a fixed point of the greedy map. Token 0 comes from
    the prefill; after sweep k the first k + 1 tokens are the greedy chain's,
    so at most ``num_new_tokens - 1`` sweeps run and the result equals
    ``greedy_generate``'s wherever a multi-token forward gives the logits
    of single-token steps.

    ``init_guess`` [B, n] warm-starts the iteration (position 0 is always
    the prefill's token). ``num_iters`` runs exactly that many sweeps
    instead (the first ``num_iters + 1`` tokens are exact). Without it, each
    sweep reads one flag (converged or not) back from the device. Returns
    the tokens [B, n] on the device, with ``return_iters`` the sweeps taken,
    and with ``return_logits`` the logits [B, n, V] that chose them: the
    prefill's for token 0, the last sweep's for the rest (at a fixed point,
    those of ``greedy_generate``'s steps)."""
    b, s, _ = prompt_embeds.shape
    n = int(num_new_tokens)
    dev = prompt_embeds.device
    max_len = max_len or (s + n)
    first, cache, valid_cols, n_valid, first_lg = _prefill(llama, prompt_embeds, attn_valid,
                                                           max_len)

    def result(tokens, iters, lg):
        extra = ((iters,) if return_iters else ()) + ((lg,) if return_logits else ())
        return (tokens, *extra) if extra else tokens

    if n == 1:
        return result(first[:, None], 0, first_lg[:, None])
    t = n - 1  # tail: tokens 0 .. n-2 predict tokens 1 .. n-1
    cols = torch.arange(max_len, device=dev)
    tail = torch.arange(t, device=dev)
    tail_mask = ((cols[None, None, :] <= (s + tail)[None, :, None]) & valid_cols).expand(b, t, max_len)
    tail_pos = n_valid[:, None] + tail[None, :]
    if init_guess is not None:
        init_guess = torch.as_tensor(init_guess, device=dev)
        guess = torch.cat([first[:, None], init_guess[:, 1:].to(first.dtype)], 1)
    else:
        guess = first[:, None].expand(b, n)
    iters, converged, tail_lg = 0, False, None
    while (iters < num_iters) if num_iters is not None else (not converged and iters < t):
        h, cache = llama(llama.embed(guess[:, :-1], prompt_embeds.dtype), tail_pos,
                         tail_mask, cache, s)
        tail_lg = llama.logits(h)
        new = torch.cat([first[:, None], tail_lg.argmax(-1)], 1)
        if num_iters is None:
            converged = bool(torch.equal(new, guess))  # the sweep's one read-back
        guess = new
        iters += 1
    lg = first_lg[:, None] if tail_lg is None else torch.cat([first_lg[:, None], tail_lg], 1)
    return result(guess, iters, lg)
