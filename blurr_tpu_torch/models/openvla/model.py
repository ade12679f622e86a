"""The OpenVLA family: OpenVLA-7B, OpenVLA-OFT and MiniVLA.

Counterpart of ``blurr_tpu/models/openvla/model.py``. The fused DINOv2 +
SigLIP towers (or SigLIP alone, MiniVLA) give 256 patch features; a
projector (3 linears with exact GELU for the fused towers, 2 for the
prismatic single tower) maps them to the LLM width; the prompt is
[BOS] + 256 patches + the prompt's other tokens (ending in the empty token
29871); the LLM decodes ``action_dim`` tokens greedily. A token id maps to
a bin as ``vocab(32000) - id``, clipped to [0, 254], then to one of 255
uniform bin centres in [-1, 1]; ``unnormalize`` applies a dataset's
q01 / q99 with its mask.

OFT (``OpenVLAOFT``) replaces the decode with one forward over
``chunk_len * action_dim`` placeholder tokens (the empty token's
embedding) that attend to each other bidirectionally; their final hidden
states, flattened, feed an MLP-ResNet head that gives a continuous chunk.
An optional proprio projector puts one more token in front of them. The
head's and projector's module names are those of the reference's
``action_head--*.pt`` / ``proprio_projector--*.pt`` state dicts.

Every entry point takes and returns tensors on the model's device; ids
and pixel values may be numpy. The training losses, ``action_ce_loss``
(teacher-forced next-token cross-entropy of the action tokens) and
``oft_l1_loss`` (L1 of OFT's continuous chunk), run the LLM's training
route (``llama.Llama.forward`` with no cache, optionally rematerialized)
and are differentiable through the LoRA factors and the OFT modules; the
decoding entry points keep the in-place cache and run without gradients.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.models.openvla import llama as llama_lib
from blurr_tpu_torch.models.openvla.llama import Llama, LlamaSpec, materialize
from blurr_tpu_torch.models.openvla.processing import EMPTY_TOKEN
from blurr_tpu_torch.models.openvla.vit import ViT, ViTSpec
from blurr_tpu_torch.ops.embeddings import embedding
from blurr_tpu_torch.ops.norms import layer_norm

DINOV2_L = ViTSpec(
    hidden_size=1024, intermediate_size=4096, num_layers=24, num_heads=16,
    cls_token=True, reg_tokens=4, layerscale=True,
)
SIGLIP_SO400M = ViTSpec(
    hidden_size=1152, intermediate_size=4304, num_layers=27, num_heads=16,
)


@dataclass(frozen=True)
class OpenVLASpec:
    llama: LlamaSpec = field(default_factory=LlamaSpec)
    dinov2: ViTSpec = DINOV2_L
    siglip: ViTSpec = SIGLIP_SO400M
    action_dim: int = 7
    n_action_bins: int = 256
    action_token_vocab: int = 32000  # the bins are the top ids of this range
    use_fused_vision: bool = True  # DINOv2 + SigLIP; False = SigLIP only

    @property
    def vision_dim(self) -> int:
        return (self.dinov2.hidden_size if self.use_fused_vision else 0) + self.siglip.hidden_size

    @staticmethod
    def from_snapshot_dir(path) -> "OpenVLASpec":
        """The spec of a snapshot directory: its ``blurr_spec.json`` (the
        dataclass fields, nested for ``llama``, ``dinov2`` and ``siglip``)
        where there is one, else OpenVLA-7B's."""
        p = Path(path) / "blurr_spec.json"
        if not p.exists():
            return OpenVLASpec()
        kw = json.loads(p.read_text())
        for key, cls in (("llama", LlamaSpec), ("dinov2", ViTSpec), ("siglip", ViTSpec)):
            if key in kw:
                kw[key] = cls(**kw[key])
        return OpenVLASpec(**kw)

    @staticmethod
    def tiny() -> "OpenVLASpec":
        """A layer-reduced spec for tests."""
        return OpenVLASpec(
            llama=LlamaSpec(vocab_size=32064, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2),
            dinov2=ViTSpec(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                           image_size=28, cls_token=True, reg_tokens=4, layerscale=True,
                           feature_layer=-1),
            siglip=ViTSpec(hidden_size=48, intermediate_size=96, num_layers=2, num_heads=2,
                           image_size=28, feature_layer=-1),
        )

    @staticmethod
    def minivla(vocab_size: int = 32064) -> "OpenVLASpec":
        """MiniVLA: SigLIP alone and Qwen2.5-0.5B's dimensions (q/k/v
        biases, tied head, rope theta 1e6, eps 1e-6), with OpenVLA's
        32064 / 32000 action-token convention."""
        return OpenVLASpec(
            llama=LlamaSpec(vocab_size=vocab_size, hidden_size=896, intermediate_size=4864,
                            num_layers=24, num_heads=14, num_kv_heads=2,
                            rope_theta=1_000_000.0, eps=1e-6, qkv_bias=True,
                            tie_word_embeddings=True),
            siglip=SIGLIP_SO400M,
            use_fused_vision=False,
        )

    @staticmethod
    def tiny_minivla() -> "OpenVLASpec":
        """A layer-reduced MiniVLA-shaped spec for tests."""
        return OpenVLASpec(
            llama=LlamaSpec(vocab_size=32064, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            rope_theta=1_000_000.0, eps=1e-6, qkv_bias=True,
                            tie_word_embeddings=True),
            siglip=ViTSpec(hidden_size=48, intermediate_size=96, num_layers=2, num_heads=2,
                           image_size=28, feature_layer=-1),
            use_fused_vision=False,
        )


# checkpoint-free model ids -> spec constructors (the servers' and CLIs' table)
RANDOM_SPECS = {
    "random": OpenVLASpec.tiny,
    "random-7b": OpenVLASpec,
    "openvla-7b-random": OpenVLASpec,
    "random-minivla": OpenVLASpec.minivla,
    "minivla-random": OpenVLASpec.minivla,
    "random-minivla-tiny": OpenVLASpec.tiny_minivla,
}


@torch.no_grad()
def init_dense(root: nn.Module, generator: torch.Generator) -> None:
    """Linear weights N(0, 1/fan_in) and biases 0, LayerNorm scales 1 and
    shifts 0, for every such module of ``root``."""
    for mod in root.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, mod.in_features**-0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class Projector(nn.Module):
    """Patch features -> LLM width: fc1 -> GELU -> fc2 (-> GELU -> fc3 for
    the fused towers)."""

    def __init__(self, vision_dim: int, llm_dim: int, fused: bool, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(vision_dim, llm_dim, **kw)
        self.fc2 = nn.Linear(llm_dim, llm_dim, **kw)
        self.fc3 = nn.Linear(llm_dim, llm_dim, **kw) if fused else None

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.fc1(feats))
        if self.fc3 is None:
            return self.fc2(x)
        return self.fc3(F.gelu(self.fc2(x)))


def _to(x, device, dtype=None) -> torch.Tensor:
    """A tensor or numpy array on ``device`` (in ``dtype`` where given)."""
    t = torch.as_tensor(x)
    return t.to(device) if dtype is None else t.to(device, dtype)


class OpenVLA(nn.Module):
    """OpenVLA / MiniVLA on ``device`` in ``dtype``. ``quant_init`` builds
    the LLM's linears quantized (``llama.Llama``). The modules are built on
    the meta device and given uninitialized storage: set the weights with
    ``init_params``, ``checkpoint.load_jax_params`` or the snapshot loader."""

    def __init__(self, spec: OpenVLASpec, norm_stats: Optional[Dict] = None, *,
                 device, dtype: torch.dtype, quant_init: Optional[str] = None):
        super().__init__()
        self.spec = s = spec
        self.norm_stats = norm_stats or {}
        bins = np.linspace(-1, 1, s.n_action_bins)
        self.bin_centers = (bins[:-1] + bins[1:]) / 2.0
        self.llama = Llama(s.llama, device=device, dtype=dtype, quant_init=quant_init)
        kw = dict(device="meta", dtype=dtype)
        self.siglip = ViT(s.siglip, **kw)
        self.dinov2 = ViT(s.dinov2, **kw) if s.use_fused_vision else None
        self.projector = Projector(s.vision_dim, s.llama.hidden_size, s.use_fused_vision, **kw)
        materialize(self, device)

    @property
    def device(self) -> torch.device:
        return self.llama.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.final_norm.dtype

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "OpenVLA":
        """Random weights from ``generator`` (on the model's device), with
        the JAX ``init_params`` distributions."""
        self.llama.init_params(generator)
        for tower in (self.siglip, self.dinov2):
            if tower is not None:
                tower.init_params(generator)
        init_dense(self.projector, generator)
        return self

    # ------------------------------------------------------------------

    def _vision_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 6 or 3, H, W] -> projected patch embeddings [B, 256, llm]. The
        fused towers take a 6-channel stack (DINOv2's normalization first)."""
        if self.dinov2 is not None:
            if pixel_values.shape[1] == 6:
                px_dino, px_sig = pixel_values[:, :3], pixel_values[:, 3:]
            else:
                px_dino = px_sig = pixel_values
            feats = torch.cat([self.dinov2(px_dino), self.siglip(px_sig)], dim=-1)
        else:
            feats = self.siglip(pixel_values)
        return self.projector(feats)

    def _build_prompt_embeds(self, input_ids, pixel_values) -> torch.Tensor:
        """[BOS] + patches + the prompt's other tokens -> [B, 1 + P + S - 1, H]."""
        tok = embedding(input_ids, self.llama.embed_tokens)
        patches = self._vision_features(pixel_values).to(tok.dtype)
        return torch.cat([tok[:, :1], patches, tok[:, 1:]], dim=1)

    def _inputs(self, input_ids, pixel_values, attn_valid=None):
        """(prompt embeddings, their validity): [BOS] and the patches always
        valid, then ``attn_valid[:, 1:]`` (right-padded prompts)."""
        input_ids = _to(input_ids, self.device).long()
        embeds = self._build_prompt_embeds(input_ids, _to(pixel_values, self.device, self.dtype))
        b = embeds.shape[0]
        n_patch = embeds.shape[1] - input_ids.shape[1]
        ones = torch.ones(b, 1 + n_patch, dtype=torch.long, device=self.device)
        if attn_valid is None:
            rest = torch.ones_like(input_ids[:, 1:])
        else:
            rest = _to(attn_valid, self.device).long()[:, 1:]
        return embeds, torch.cat([ones, rest], dim=1)

    @torch.no_grad()
    def predict_action_tokens(self, input_ids, pixel_values) -> torch.Tensor:
        """Greedy decode of ``action_dim`` tokens [B, action_dim]."""
        return llama_lib.greedy_generate(self.llama, *self._inputs(input_ids, pixel_values),
                                         self.spec.action_dim)

    @torch.no_grad()
    def predict_action_tokens_ragged(self, input_ids, pixel_values, attn_valid) -> torch.Tensor:
        """Greedy decode with right-padded prompts in one batch: each row
        gives what it gives alone."""
        return llama_lib.greedy_generate(
            self.llama, *self._inputs(input_ids, pixel_values, attn_valid), self.spec.action_dim)

    @torch.no_grad()
    def predict_action_tokens_jacobi(self, input_ids, pixel_values, attn_valid=None,
                                     return_iters: bool = False, init_guess=None,
                                     num_iters: Optional[int] = None):
        """The tokens of ``predict_action_tokens_ragged`` by Jacobi decoding
        (``llama.greedy_generate_jacobi``)."""
        return llama_lib.greedy_generate_jacobi(
            self.llama, *self._inputs(input_ids, pixel_values, attn_valid),
            self.spec.action_dim, return_iters=return_iters, init_guess=init_guess,
            num_iters=num_iters)

    def detokenize_actions(self, token_ids) -> np.ndarray:
        """Token ids [B, action_dim] -> normalized actions in [-1, 1]."""
        discretized = self.spec.action_token_vocab - np.asarray(token_ids)
        discretized = np.clip(discretized - 1, 0, self.bin_centers.shape[0] - 1)
        return self.bin_centers[discretized]

    def tokenize_actions(self, actions) -> np.ndarray:
        """Normalized actions -> token ids, ``detokenize_actions``'s inverse
        up to half a bin (OpenVLA's ActionTokenizer: digitize, vocab - bin)."""
        a = np.clip(np.asarray(actions), -1.0, 1.0)
        discretized = np.digitize(a, np.linspace(-1, 1, self.spec.n_action_bins))
        return (self.spec.action_token_vocab - discretized).astype(np.int32)

    def action_ce_loss(self, input_ids, attn_valid, pixel_values, action_tokens,
                       remat: bool = False) -> torch.Tensor:
        """Teacher-forced next-token cross-entropy over the ``action_dim``
        action tokens, a 0-d fp32 tensor. ``input_ids`` [B, T] hold each
        prompt with its label tokens appended right after it (right padding
        at the end), ``attn_valid`` [B, T] covers prompt and labels, and
        ``action_tokens`` [B, action_dim] are the labels. Label i sits at
        id position n_prompt + i, is predicted from the position before it,
        and id position j embeds at n_patch + j: the ``action_dim`` hidden
        rows are gathered before the head, which runs on them alone."""
        s = self.spec
        ids = _to(input_ids, self.device).long()
        attn_valid = _to(attn_valid, self.device).long()
        labels = _to(action_tokens, self.device).long()
        embeds, valid = self._inputs(ids, pixel_values, attn_valid)
        b, total, h = embeds.shape
        n_patch = total - ids.shape[1]
        pos = torch.arange(total, device=self.device)[None].expand(b, total)
        hid, _ = self.llama(embeds, pos, llama_lib.causal_prefill_mask(valid, total), None,
                            remat=remat)
        n_prompt = attn_valid.sum(-1) - s.action_dim
        label_pos = (n_patch + n_prompt[:, None] - 1
                     + torch.arange(s.action_dim, device=self.device)[None])
        sel = hid.gather(1, label_pos[..., None].expand(b, s.action_dim, h))
        logp = torch.log_softmax(self.llama.logits(sel).float(), dim=-1)
        return -logp.gather(-1, labels[..., None]).mean()

    def unnormalize(self, normalized: np.ndarray, unnorm_key: str) -> np.ndarray:
        stats = self.norm_stats[unnorm_key]["action"]
        high, low = np.asarray(stats["q99"]), np.asarray(stats["q01"])
        mask = np.asarray(stats.get("mask", np.ones_like(low, dtype=bool)))
        return np.where(mask, 0.5 * (normalized + 1) * (high - low) + low, normalized)

    def predict_action(self, input_ids, pixel_values, unnorm_key: Optional[str] = None
                       ) -> np.ndarray:
        """The HF remote code's surface: unnormalized actions [action_dim]
        (batch 1) or [B, action_dim], as numpy. The empty token is appended
        where the prompt lacks it."""
        input_ids = _to(input_ids, self.device).long()
        if int(input_ids[0, -1]) != EMPTY_TOKEN:
            pad = torch.full((input_ids.shape[0], 1), EMPTY_TOKEN, dtype=input_ids.dtype,
                             device=input_ids.device)
            input_ids = torch.cat([input_ids, pad], dim=1)
        toks = self.predict_action_tokens(input_ids, pixel_values).cpu().numpy()
        actions = self.detokenize_actions(toks)
        if unnorm_key is not None:
            actions = self.unnormalize(actions, unnorm_key)
        return actions[0] if actions.shape[0] == 1 else actions

    def get_action_dim(self, unnorm_key: str) -> int:
        return len(self.norm_stats[unnorm_key]["action"]["q01"])


# ---------------------------------------------------------------------------
# OFT: the continuous action head (parallel decoding)
# ---------------------------------------------------------------------------


class OFTActionHead(nn.Module):
    """MLP-ResNet regression head, the reference's ``_OFTActionHead``: LN ->
    fc1 -> [x + Linear(LN(x))] * n_blocks (no activation) -> LN -> fc2. The
    module names are the checkpoint's (``layer_norm1``, ``fc1``,
    ``mlp_resnet_blocks.{i}.ffn.{0: LN, 1: Linear}``, ``layer_norm2``,
    ``fc2``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, n_blocks: int, *,
                 device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(in_dim, **kw)
        self.fc1 = nn.Linear(in_dim, hidden_dim, **kw)
        self.mlp_resnet_blocks = nn.ModuleList(
            nn.ModuleDict({"ffn": nn.Sequential(nn.LayerNorm(hidden_dim, **kw),
                                                nn.Linear(hidden_dim, hidden_dim, **kw))})
            for _ in range(n_blocks)
        )
        self.layer_norm2 = nn.LayerNorm(hidden_dim, **kw)
        self.fc2 = nn.Linear(hidden_dim, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(layer_norm(x, self.layer_norm1.weight, self.layer_norm1.bias, 1e-5))
        for block in self.mlp_resnet_blocks:
            ln, lin = block["ffn"]
            x = x + lin(layer_norm(x, ln.weight, ln.bias, 1e-5))
        return self.fc2(layer_norm(x, self.layer_norm2.weight, self.layer_norm2.bias, 1e-5))


class OFTProprioProjector(nn.Module):
    """fc2(relu(fc1(x))), the reference's ``_OFTProprioProjector``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *, device, dtype):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden_dim, out_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class OpenVLAOFT(OpenVLA):
    """Parallel decoding: one forward over ``chunk_len * action_dim``
    placeholder tokens whose final hidden states feed the continuous head."""

    def __init__(self, spec: OpenVLASpec, norm_stats: Optional[Dict] = None,
                 chunk_len: int = 8, use_proprio: bool = False, proprio_dim: int = 8, *,
                 device, dtype: torch.dtype, quant_init: Optional[str] = None):
        super().__init__(spec, norm_stats, device=device, dtype=dtype, quant_init=quant_init)
        self.chunk_len = chunk_len
        self.use_proprio = use_proprio
        self.proprio_dim = proprio_dim
        h = spec.llama.hidden_size
        n_tok = chunk_len * spec.action_dim
        kw = dict(device="meta", dtype=dtype)
        self.action_head = OFTActionHead(n_tok * h, h, n_tok, 2, **kw)
        self.proprio_projector = (OFTProprioProjector(proprio_dim, h, h, **kw)
                                  if use_proprio else None)
        materialize(self, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "OpenVLAOFT":
        super().init_params(generator)
        init_dense(self.action_head, generator)
        if self.proprio_projector is not None:
            init_dense(self.proprio_projector, generator)
        return self

    @torch.no_grad()
    def predict_action_continuous(self, input_ids, pixel_values, proprio=None,
                                  attn_valid=None) -> torch.Tensor:
        """Normalized actions [B, chunk_len, action_dim] on the device.
        Right-padded prompts (``attn_valid``) keep their pad columns masked,
        and the tail (proprio token, empty token, placeholders) takes
        positions from each row's own prompt length."""
        return self.continuous_chunk(input_ids, pixel_values, proprio, attn_valid)

    def oft_l1_loss(self, input_ids, pixel_values, actions, proprio=None, attn_valid=None,
                    remat: bool = False) -> torch.Tensor:
        """OFT's fine-tuning objective: the mean |chunk - actions| of the
        parallel-decoded chunk against the targets [B, chunk_len,
        action_dim] (cast to the chunk's dtype), on the training route.
        Ragged right-padded prompts ride ``attn_valid``: each row computes
        its unpadded forward."""
        pred = self.continuous_chunk(input_ids, pixel_values, proprio, attn_valid,
                                     train=True, remat=remat)
        return (pred - _to(actions, pred.device, pred.dtype)).abs().mean()

    def continuous_chunk(self, input_ids, pixel_values, proprio=None, attn_valid=None,
                         train: bool = False, remat: bool = False) -> torch.Tensor:
        """``predict_action_continuous``'s forward, with gradients where the
        caller keeps them: ``train`` runs the LLM's training route (no
        cache; ``remat`` recomputes its layers in the backward), else the
        serving route writes an in-place cache."""
        s = self.spec
        embeds, v_prefix = self._inputs(input_ids, pixel_values, attn_valid)
        b, s_e, h = embeds.shape
        dev = embeds.device
        tail = []
        if self.use_proprio and proprio is not None:
            pe = self.proprio_projector(_to(proprio, dev, embeds.dtype))
            tail.append(pe[:, None, :])
        n_tok = self.chunk_len * s.action_dim
        # the trailing empty token and the placeholders, all its embedding
        empty = torch.full((1, 1), EMPTY_TOKEN, dtype=torch.long, device=dev)
        tail.append(embedding(empty, self.llama.embed_tokens).to(embeds.dtype)
                    .expand(b, 1 + n_tok, h))
        embeds = torch.cat([embeds, *tail], dim=1)
        total = embeds.shape[1]
        n_tail = total - s_e
        pos = torch.cat([torch.arange(s_e, device=dev)[None].expand(b, s_e),
                         v_prefix.sum(-1)[:, None] + torch.arange(n_tail, device=dev)[None]],
                        dim=1)
        # the prompt stays causal with its pad columns masked; the
        # placeholders attend to each other bidirectionally
        mask = llama_lib.causal_prefill_mask(
            torch.cat([v_prefix, torch.ones(b, n_tail, dtype=torch.long, device=dev)], 1), total)
        act = torch.arange(total, device=dev) >= total - n_tok
        mask = mask | (act[None, :, None] & act[None, None, :])
        cache = None if train else llama_lib.alloc_cache(
            s.llama, b, total, embeds.dtype, dev, self.llama.kv_heads)
        hid, _ = self.llama(embeds, pos, mask, cache, 0, remat=remat)
        hid = self.llama.final_hidden(hid)
        out = self.action_head(hid[:, -n_tok:].reshape(b, -1))
        return out.reshape(b, self.chunk_len, s.action_dim)

    def predict_action(self, input_ids, pixel_values, unnorm_key: Optional[str] = None,
                       proprio=None) -> np.ndarray:
        out = self.predict_action_continuous(input_ids, pixel_values, proprio)
        out = out.float().cpu().numpy()
        if unnorm_key is not None:
            out = self.unnormalize(out, unnorm_key)
        return out[0] if out.shape[0] == 1 else out
