"""Standalone PaliGemma and Gemma greedy text generation.

Counterpart of ``blurr_tpu/models/paligemma/model.py``
(``PaliGemmaForConditionalGeneration``, ``GemmaForCausalLM``; the
reference's ``src/model/paligemma/gemma.py``). Both run the Gemma decoder
stack as the joint engine's one-mixture path (``joint.single_forward``)
over a preallocated append-mode cache, with the token embedding as the
tied head, applied to the last position only. PaliGemma puts SigLIP's
projected features at the image-token slots first (``merge_embeds``, as
Pi-0 does); Gemma embeds its tokens straight from the table and has no
vision tower.

Unlike Pi-0's joint attention, Gemma's applies NO soft clamp (the
reference's ``GemmaAttention`` is a plain scaled dot product), and JAX
leaves this model on its XLA attention, so it attends through the plain
``grouped_attention`` with ``use_softclamp=False``. The cache is written in
place and ``cache_len`` is a host int. ``generate`` stops on the host once
every row has emitted EOS; ``generate_fused`` (JAX's one-program form) runs
every step on the device and copies the tokens to the host once, at the
end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.models.paligemma.config import GemmaConfig, PaliGemmaConfig
from blurr_tpu_torch.models.pi0 import joint as joint_lib
from blurr_tpu_torch.models.pi0.joint import JointSpec, Mixture, MixtureSpec
from blurr_tpu_torch.models.pi0.pizero import (
    decode_mask,
    init_weights,
    materialize,
    merge_embeds,
    text_mask,
)
from blurr_tpu_torch.models.pi0.siglip import SiglipVisionModel, projector


class _GemmaStack(nn.Module):
    """The token embedding (the tied head) and the Gemma decoder stack as
    one ``vlm`` mixture with a final norm; built on the meta device, the
    subclass gives it storage once its own modules are there."""

    def __init__(self, text: GemmaConfig, dtype: torch.dtype):
        super().__init__()
        self.joint_spec = JointSpec(
            num_hidden_layers=text.num_hidden_layers,
            num_attention_heads=text.num_attention_heads,
            num_key_value_heads=text.num_key_value_heads,
            head_dim=text.head_dim,
            rms_norm_eps=text.rms_norm_eps,
            use_softclamp=False,
            mixtures={"vlm": MixtureSpec(
                hidden_size=text.hidden_size,
                intermediate_size=text.intermediate_size,
                rope_theta=float(text.rope_theta),
                use_final_norm=True,
            )},
        )
        kw = dict(device="meta", dtype=dtype)
        self.embed_tokens = nn.Parameter(torch.empty(text.vocab_size, text.hidden_size, **kw))
        self.vlm = Mixture(self.joint_spec.mixtures["vlm"], self.joint_spec, **kw)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Random weights drawn in place from ``generator`` (on the
        parameters' device) with JAX's ``init_params`` distributions: the
        embedding N(0, 1/hidden), dense weights N(0, 1/fan_in), biases and
        Gemma norm scales 0, LayerNorm scales 1, SigLIP's position
        embedding N(0, 1/width)."""
        init_weights(self, generator, self.embed_tokens, getattr(self, "vision_tower", None))
        return self

    @torch.no_grad()
    def _prefill(self, embeds: torch.Tensor, max_cache_len: int):
        """The prompt's embeddings through the stack at positions 1..q_len,
        bidirectionally; returns (logits [B, 1, V] of the last position, the
        cache of ``max_cache_len``, cache_len)."""
        bsz, q_len = embeds.shape[:2]
        pos = torch.arange(1, q_len + 1, device=embeds.device).expand(bsz, q_len)
        cache = joint_lib.alloc_single_cache(
            self.joint_spec, bsz, max_cache_len, embeds.dtype, embeds.device
        )
        valid = torch.ones(bsz, q_len, dtype=torch.bool, device=embeds.device)
        hidden, cache = joint_lib.single_forward(
            self.vlm, self.joint_spec, "vlm", embeds, pos,
            text_mask(valid, q_len, max_cache_len), cache, 0,
        )
        return hidden[:, -1:] @ self.embed_tokens.T, cache, q_len

    @torch.no_grad()
    def decode_logits(self, token: torch.Tensor, cache, cache_len: int):
        """One step on ``token`` [B] or [B, 1]: (logits [B, 1, V], the
        cache, cache_len + 1)."""
        if token.dim() == 1:
            token = token[:, None]
        bsz = token.shape[0]
        pos = torch.full((bsz, 1), cache_len + 1, device=token.device)
        mask = decode_mask(cache_len, cache[0].shape[3], bsz, token.device)
        hidden, cache = joint_lib.single_forward(
            self.vlm, self.joint_spec, "vlm", F.embedding(token, self.embed_tokens), pos,
            mask, cache, cache_len,
        )
        return hidden @ self.embed_tokens.T, cache, cache_len + 1

    def decode_step(self, token: torch.Tensor, cache, cache_len: int):
        """One greedy step: (next token [B], the cache, cache_len + 1)."""
        logits, cache, cache_len = self.decode_logits(token, cache, cache_len)
        return logits[:, -1].argmax(-1), cache, cache_len

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.embed_tokens.device).long()

    def _greedy(self, logits, cache, cache_len: int, max_new_tokens: int,
                eos_token_id: Optional[int]) -> np.ndarray:
        """Greedy decoding after the prefill, EOS on the host: a finished
        row repeats EOS, and the loop stops once every row has finished.
        Returns the tokens [B, T], T <= max_new_tokens."""
        tok = logits[:, -1].argmax(-1)
        out = [tok.cpu().numpy()]
        done = None if eos_token_id is None else out[-1] == eos_token_id
        for _ in range(max_new_tokens - 1):
            if done is not None and done.all():
                break
            tok, cache, cache_len = self.decode_step(tok, cache, cache_len)
            nxt = tok.cpu().numpy()
            if done is not None:
                nxt = np.where(done, eos_token_id, nxt)
                done = done | (nxt == eos_token_id)
                tok = torch.from_numpy(nxt).to(tok.device)
            out.append(nxt)
        return np.stack(out, axis=1)


class PaliGemmaForConditionalGeneration(_GemmaStack):
    """PaliGemma: SigLIP, the projector and the Gemma stack, on ``device``
    in ``dtype`` with uninitialized weights (``init_params``,
    ``checkpoint.load_jax_params`` or ``load.load_hf_model`` set them)."""

    def __init__(self, config: PaliGemmaConfig, *, device="cuda", dtype=torch.float32):
        super().__init__(config.text_config, dtype)
        self.config = config
        self.vision_cfg = config.vision_config.to_dict()
        kw = dict(device="meta", dtype=dtype)
        self.vision_tower = SiglipVisionModel(self.vision_cfg, **kw)
        self.multi_modal_projector = projector(
            {"vision_config": {"hidden_size": self.vision_cfg["hidden_size"],
                               "projection_dim": config.projection_dim}}, **kw)
        materialize(self, device)

    def _merge_embeds(self, input_ids, pixel_values) -> torch.Tensor:
        cfg = self.config
        feats = self.multi_modal_projector(self.vision_tower(pixel_values))
        return merge_embeds(self.embed_tokens, feats, input_ids, cfg.image_token_index,
                            cfg.pad_token_id or 0, cfg.hidden_size)

    @torch.no_grad()
    def prefill(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                max_cache_len: int):
        """(logits [B, 1, V] of the last position, cache, cache_len)."""
        return self._prefill(self._merge_embeds(input_ids, pixel_values), max_cache_len)

    def _inputs(self, input_ids, pixel_values):
        """Token ids as int64 and pixels in the model's dtype, on its device
        (JAX promotes fp32 pixels against bf16 weights; here they are cast)."""
        px = torch.as_tensor(pixel_values, device=self.embed_tokens.device)
        return self._ids(input_ids), px.to(self.embed_tokens.dtype)

    @torch.no_grad()
    def generate(self, input_ids, pixel_values, max_new_tokens: int = 20,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy generation with EOS on the host; tokens [B, T]."""
        ids, px = self._inputs(input_ids, pixel_values)
        logits, cache, cache_len = self.prefill(ids, px, ids.shape[1] + max_new_tokens)
        return self._greedy(logits, cache, cache_len, max_new_tokens, eos_token_id)

    @torch.no_grad()
    def fused_tokens(self, input_ids, pixel_values, max_new_tokens: int = 20,
                     eos_token_id: Optional[int] = None):
        """``generate_fused``'s tokens [B, max_new_tokens] and the last
        step's logits [B, V], left on the device: every step runs there
        (``done`` is a device tensor, each token is written into a
        preallocated device tensor), so with its inputs on the device
        nothing here waits for it."""
        ids, px = self._inputs(input_ids, pixel_values)
        logits, cache, cache_len = self.prefill(ids, px, ids.shape[1] + max_new_tokens)
        tok = logits[:, -1].argmax(-1)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        out = torch.empty(tok.shape[0], max_new_tokens, dtype=tok.dtype, device=tok.device)
        out[:, 0] = tok
        done = tok == eos
        for i in range(1, max_new_tokens):
            logits, cache, cache_len = self.decode_logits(tok, cache, cache_len)
            tok = logits[:, -1].argmax(-1).masked_fill(done, eos)
            done = done | (tok == eos)
            out[:, i] = tok
        return out, logits[:, -1]

    def generate_fused(self, input_ids, pixel_values, max_new_tokens: int = 20,
                       eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy generation with no host round trip per token: all
        ``max_new_tokens`` steps (a finished row repeats EOS), one copy to
        the host at the end. The same tokens as ``generate``, which may stop
        earlier."""
        tokens, _ = self.fused_tokens(input_ids, pixel_values, max_new_tokens, eos_token_id)
        return tokens.cpu().numpy()


class GemmaForCausalLM(_GemmaStack):
    """Text-only Gemma (the reference's ``GemmaForCausalLM``): the token
    embedding and the decoder stack, no vision tower. Takes a
    ``GemmaConfig`` or a ``PaliGemmaConfig`` (its text config)."""

    def __init__(self, config, *, device="cuda", dtype=torch.float32):
        text = getattr(config, "text_config", config)
        super().__init__(text, dtype)
        self.config = text
        materialize(self, device)

    @torch.no_grad()
    def prefill(self, input_ids: torch.Tensor, max_cache_len: int):
        """Pure-text prefill: (logits [B, 1, V], cache, cache_len)."""
        return self._prefill(F.embedding(input_ids, self.embed_tokens), max_cache_len)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        ids = self._ids(input_ids)
        logits, cache, cache_len = self.prefill(ids, ids.shape[1] + max_new_tokens)
        return self._greedy(logits, cache, cache_len, max_new_tokens, eos_token_id)
