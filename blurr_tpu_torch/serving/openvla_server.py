"""OpenVLA-family action serving: the port's ActionServer runtime driving
OpenVLA, OpenVLA-OFT and MiniVLA instead of Pi-0.

Counterpart of ``blurr_tpu/serving/openvla_server.py``. Each request: the
prompt built and tokenized (cached, at most 1024 instructions), right-padded
to ``max_text_tokens``; the image resized by the Lanczos ladder and
normalized for each tower on the host; then, under the device lock, one step
over the request alone or, with ``max_batch`` > 1, over its bucket (the
Pi-0 server's dynamic batching, backpressure and stats): the greedy decode
of ``action_dim`` tokens over the right-padded ragged prompts
(``decode="ar"``), its Jacobi form (``decode="jacobi"``, the same tokens
wherever a multi-token forward gives a single step's logits) or OFT's one
parallel forward (``oft=True``, with each request's proprio when
``use_proprio``); then bin-centre detokenization of the live rows and, with
``unnorm_key``, the q01 / q99 unnormalization on the host. The wire
protocol and the clients are Pi-0's.

``checkpoint_path`` serves a parameter tree of the port's trainer
(``scripts/train_openvla_lora_torch.py --save-params``) through
``build_openvla(checkpoint_path=...)``, its adapters unmerged over its
quantized bases, and ``reload_checkpoint`` swaps one in while serving (the
Pi-0 server's atomic and ``drop_first`` reloads), held against the startup
model's tensors and module types.

``tp`` / ``dp`` > 1 run the Pi-0 server's ranks (``serving/server.py``) for
AR, Jacobi and OFT alike: LLaMA's heads (K/V with Q: it is multi-head), its
MLP, its head and its embedding split over the model ranks, SigLIP's MLP
and output projection too (``parallel/mesh.py:rule_for``), and a reload
re-shards on every rank, as JAX's does. JAX re-lays the 7B's q/k/v for
Jacobi on one chip only (``relayout_qkv_for_jacobi``, skipped under tp or
dp); the port has no such relayout (a TPU layout fix), so nothing is
skipped here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from blurr_tpu_torch.models.openvla.build import build_openvla
from blurr_tpu_torch.models.openvla.processing import (
    OpenVLAProcessor,
    process_image,
    tokenize_prompt_ids,
)
from blurr_tpu_torch.parallel.mesh import shard_params
from blurr_tpu_torch.serving.server import ActionServer, model_signature

TOKEN_CACHE_SIZE = 1024


class OpenVLAActionServer(ActionServer):
    """Serves OpenVLA-family actions on ``device`` over TCP.

    ``model_id``: an HF snapshot dir, or a ``model.RANDOM_SPECS`` id
    ('random', 'random-7b', 'random-minivla', ...) whose weights are drawn
    on the device from a generator seeded with ``seed`` (JAX's server takes
    ``seed`` for its request PRNG, which a greedy decode never reads, and
    draws random weights from ``PRNGKey(0)``). ``quantization`` 'w8a8' /
    'w4a8' quantizes the LLM (a checkpoint-free one is drawn quantized).
    ``unnorm_key`` selects the norm statistics applied to the answers; None
    returns normalized actions. ``checkpoint_path`` replaces every weight by
    a trained parameter tree (``model_id`` still gives the spec, the
    tokenizer and the statistics). ``max_batch``, ``batch_window_ms``,
    ``max_queue`` and ``bucket_mode`` are dynamic batching's, as in the Pi-0
    server.
    """

    def __init__(self, model_id: str = "random", quantization: Optional[str] = None,
                 unnorm_key: Optional[str] = None, use_bf16: bool = True, seed: int = 42,
                 max_batch: int = 1, batch_window_ms: float = 2.0, tp: int = 1,
                 dp: int = 1, max_text_tokens: int = 32, oft: bool = False,
                 chunk_len: int = 8, use_proprio: bool = False, proprio_dim: int = 8,
                 checkpoint_path: Optional[str] = None, max_queue: int = 0,
                 decode: str = "ar", bucket_mode: str = "pow2", *, device="cuda",
                 init_method: Optional[str] = None, _rank: int = 0):
        ctor = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        if decode not in ("ar", "jacobi"):
            raise ValueError(f"decode {decode!r}: expected 'ar'/'jacobi'")
        self._init_parallel(tp, dp, max_batch, bucket_mode, device, init_method, _rank, ctor)
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.unnorm_key = unnorm_key
        self.max_text_tokens = int(max_text_tokens)
        self.oft = bool(oft)
        self.use_proprio = bool(use_proprio) and self.oft
        self.proprio_dim = int(proprio_dim)
        self.decode = decode
        # a reload builds through the same arguments (_build)
        self._build_kw = dict(device=self.device, dtype=self.dtype, oft=self.oft,
                              chunk_len=chunk_len, use_proprio=self.use_proprio,
                              proprio_dim=proprio_dim, quantization=quantization,
                              memory_safe_quant_init=True, seed=seed)
        self._model_id = model_id
        with self._ranks_stop_on_error():
            built = self._build(checkpoint_path)
            if unnorm_key is not None and unnorm_key not in built.model.norm_stats:
                raise ValueError(f"unnorm_key {unnorm_key!r} not in the model's norm stats "
                                 f"{sorted(built.model.norm_stats)}")
        self.model = built.model
        self._signature = model_signature(self.model)
        self.spec = built.spec
        self.processor = OpenVLAProcessor(built.tokenizer, image_size=self.spec.siglip.image_size,
                                          fused=self.spec.use_fused_vision)
        self._checkpoint_desc = str(checkpoint_path or model_id)
        if self.rank == 0:
            self._join_ranks()
            self._init_runtime(max_batch, batch_window_ms, max_queue, bucket_mode)

    def _build(self, checkpoint_path):
        """``build_openvla``, the model then sharded over this rank's model
        group (a no-op on one rank)."""
        built = build_openvla(self._model_id, checkpoint_path=checkpoint_path or None,
                              **self._build_kw)
        shard_params(built.model, self.mesh)
        return built

    def _build_model(self, checkpoint_path):
        """The reload's model: the startup ``build_openvla`` call with the
        new tree (JAX ``_build_params``); ``reload_checkpoint`` checks it
        against the served one before the swap."""
        return self._build(checkpoint_path).model

    def _prepare(self, image: np.ndarray, instruction: str, proprio=None):
        """(ids, attention mask, pixel values[, proprio]) on the device,
        batch 1. proprio rides the shared request schema: only an OFT server
        with ``use_proprio`` reads it, and then it is required."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be HxWx3 uint8, got {image.shape}")
        with self._tok_lock:
            cached = self._tok_cache.get(instruction)
        if cached is None:
            ids = tokenize_prompt_ids(self.processor.tokenizer, instruction,
                                      self.max_text_tokens)
            pad = self.max_text_tokens - len(ids)
            cached = (torch.tensor([ids + [0] * pad]), torch.tensor([[1] * len(ids) + [0] * pad]))
            with self._tok_lock:
                if len(self._tok_cache) >= TOKEN_CACHE_SIZE:  # bound daemon memory
                    self._tok_cache.pop(next(iter(self._tok_cache)), None)
                self._tok_cache[instruction] = cached
        px = process_image(np.asarray(image), self.processor.image_size, self.processor.fused)
        dev = self.device
        out = (cached[0].to(dev), cached[1].to(dev),
               torch.from_numpy(px).to(dev, self.dtype))
        if self.use_proprio:
            if proprio is None:
                raise ValueError("this OFT server conditions on proprio; "
                                 "the request's proprio field is required")
            p = np.asarray(proprio, np.float32).reshape(1, -1)
            if p.shape[1] != self.proprio_dim:
                raise ValueError(f"proprio has {p.shape[1]} dims, server expects "
                                 f"{self.proprio_dim}")
            out = out + (torch.from_numpy(p).to(dev, self.dtype),)
        return out

    def _step(self, ids, am, px, proprio=None, *, request_idx: int = 0) -> np.ndarray:
        """Action tokens [B, action_dim] (OFT: the chunks [B, chunk_len,
        action_dim]) on the host, for a request or a bucket of them; the
        index is not read (greedy decoding draws no noise)."""
        inputs = (ids, am, px) if proprio is None else (ids, am, px, proprio)
        return self._run(inputs).cpu().numpy()

    def _infer(self, ids, am, px, proprio=None) -> torch.Tensor:
        """The decode (or OFT's forward) on this rank's rows."""
        m = self.model
        if self.oft:
            out = m.predict_action_continuous(ids, px, proprio, attn_valid=am).float()
        elif self.decode == "jacobi":
            out = m.predict_action_tokens_jacobi(ids, px, am)
        else:
            out = m.predict_action_tokens_ragged(ids, px, am)
        return out

    def _post(self, out: np.ndarray) -> np.ndarray:
        actions = np.asarray(out, np.float32) if self.oft else self.model.detokenize_actions(out)
        if self.unnorm_key is not None:
            actions = self.model.unnormalize(actions, self.unnorm_key)
        return actions.astype(np.float32)

    def _dummy_request(self):
        size = self.spec.siglip.image_size
        proprio = [0.0] * self.proprio_dim if self.use_proprio else None
        return (np.zeros((size, size, 3), np.uint8), "warmup", proprio)
