"""LoRA adapters for fine-tuning: the adapter module, its injection, its
merge and its trainable mask.

Counterpart of the training half of ``blurr_tpu/ops/lora.py``
(``init_lora_params``, ``is_lora_dict``, ``inject_lora_tree``,
``merge_lora_tree``, ``lora_trainable_mask``; its one-weight helpers
``apply_lora`` and ``merge_lora`` are ``mm`` of a LoRA dict and
``merge_lora_tree`` here; both forms share ``ops.quant.lora_delta``). JAX
turns a target weight leaf into a dict ``{"w", "lora_a", "lora_b",
"lora_s"}`` that ``ops.quant.mm`` dispatches; here the target linear module
is wrapped in a ``LoRALinear`` holding the same tensors under the same names
and layouts (``lora_a`` [in, r], ``lora_b`` [r, out], ``lora_s`` an fp32
scalar), so a JAX adapter tree copies over byte for byte
(``models/pi0/checkpoint.py:load_jax_params``). The base may be an
``nn.Linear`` or any quantized linear of ``ops/quant.py`` (QLoRA: the frozen
base runs int8 or int4 with straight-through gradients, and only the
factors train). ``ops.quant.mm`` also dispatches the dict form.

The PEFT half: ``save_peft_adapter`` writes the adapters of an OpenVLA
LLM (``models/openvla/llama.Llama``) as a PEFT ``lora_adapter/`` directory
(``adapter_config.json`` + ``adapter_model.safetensors``, torch [out, in]
factors under ``base_model.model.language_model.model.layers.{i}.
self_attn.q_proj.lora_A.weight``-style keys), the format the reference's
eval merges at load; ``merge_peft_adapter_into_llama`` merges such a
directory (or ``adapter_model.bin``) into the LLM's fp weights, a module or
a JAX-layout tree, unless the base already holds the delta
(``_adapter_already_merged``); ``maybe_merge_lora_adapter`` merges
``<dir>/lora_adapter/`` where there is one and logs a warning, leaving the
weights unmerged, where it cannot be read. The files are read and written
by the port's own safetensors reader and writer.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.ops.quant import linear, lora_delta

log = logging.getLogger(__name__)

# JAX's weight keys, by the attribute of the port's module that holds them:
# the mixture linears and the SigLIP layer linears
TARGET_ATTRS = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
    "out_w": "out_proj", "fc1_w": "fc1", "fc2_w": "fc2",
}


def init_lora_params(generator: torch.Generator, in_dim: int, out_dim: int, r: int,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A ~ N(0, 1/r) [in, r], B = 0 [r, out] on the generator's device: the
    adapter starts as the identity."""
    device = generator.device
    return {
        "a": torch.randn(in_dim, r, generator=generator, device=device, dtype=dtype)
        * (r**-0.5),
        "b": torch.zeros(r, out_dim, device=device, dtype=dtype),
    }


def is_lora_dict(x) -> bool:
    return isinstance(x, dict) and "lora_a" in x


class LoRALinear(nn.Module):
    """y = base(x) + s * (x @ A) @ B. ``base`` is frozen (an ``nn.Linear``
    or a quantized linear); ``lora_a`` [in, r] and ``lora_b`` [r, out] are
    the parameters that train; ``lora_s`` is a frozen fp32 scalar buffer.
    The mixture's activation clip goes to a quantized base only, never to
    the adapter branch (JAX ``mm``). An ``nn.Linear`` base adds its bias
    after the adapter, as JAX adds a separate bias leaf after ``mm``."""

    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 lora_s: torch.Tensor):
        super().__init__()
        self.base = base
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)
        self.register_buffer("lora_s", lora_s.detach().to(torch.float32, copy=True))
        self.in_features, self.rank = lora_a.shape
        self.out_features = lora_b.shape[1]

    @property
    def bias(self):
        return getattr(self.base, "bias", None)

    def forward(self, x, activation_clip: Optional[float] = None):
        return self.product(x, activation_clip, self.lora_a, self.lora_b)

    def product(self, x, activation_clip, lora_a, lora_b):
        """``forward`` with the factors given: the tensor-parallel wrappers
        pass them through their differentiable collectives
        (``parallel/tensor_parallel.py``)."""
        plain = isinstance(self.base, nn.Linear)
        if plain:
            y = F.linear(x, self.base.weight)
        else:
            y = linear(self.base, x, activation_clip)
        y = y + lora_delta(x, lora_a, lora_b, self.lora_s)
        if plain and self.base.bias is not None:
            y = y + self.base.bias
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"rank={self.rank}, scale={float(self.lora_s):g}")


def _dims(mod: nn.Module) -> Optional[Tuple[int, int]]:
    """(in, out) of a linear module that can take an adapter; None for an
    adapter already there and for any other module."""
    if isinstance(mod, LoRALinear):
        return None
    if hasattr(mod, "in_features") and hasattr(mod, "out_features"):
        return mod.in_features, mod.out_features
    return None


def inject_lora_tree(root: nn.Module, generator: torch.Generator, rank: int,
                     targets: Tuple[str, ...] = ("q_w", "v_w"),
                     alpha: Optional[float] = None, dtype=None) -> int:
    """Wrap every linear of ``root`` (and its submodules) whose JAX key is in
    ``targets`` in a ``LoRALinear``, in place: A ~ N(0, 1/r) drawn from
    ``generator`` (module order), B = 0, s = alpha/r (alpha defaults to r).
    The keys are JAX's (``q_w`` ... ``down_w`` of the mixtures, ``q_w``,
    ``k_w``, ``v_w``, ``out_w``, ``fc1_w``, ``fc2_w`` of SigLIP's layers;
    ``TARGET_ATTRS``); an existing adapter is not wrapped again. The
    factors take ``dtype``, else the base weight's dtype, or fp32 over a
    quantized base (JAX's rule). Returns the number of adapters made."""
    attrs = {TARGET_ATTRS[t] for t in targets if t in TARGET_ATTRS}
    scale = torch.tensor(float(alpha if alpha is not None else rank) / float(rank))
    made = 0
    for mod in list(root.modules()):
        if isinstance(mod, LoRALinear):
            continue
        for attr in sorted(attrs):
            base = getattr(mod, attr, None) if attr in mod._modules else None
            dims = _dims(base) if base is not None else None
            if dims is None:
                continue
            din, dout = dims
            dt = dtype
            if dt is None:
                dt = base.weight.dtype if type(base) is nn.Linear else torch.float32
            device = next(itertools.chain(base.parameters(), base.buffers())).device
            init = init_lora_params(generator, din, dout, rank, torch.float32)
            setattr(mod, attr, LoRALinear(base, init["a"].to(device, dt),
                                          init["b"].to(device, dt), scale.to(device)))
            made += 1
    return made


@torch.no_grad()
def merge_lora_tree(root: nn.Module) -> int:
    """Fold every adapter of ``root`` back into its ``nn.Linear`` base
    (W + s * A @ B, in the base's dtype) and put the base in its place, in
    place. A quantized base cannot absorb the fp delta: raises ValueError,
    as JAX does (serve the adapter modules directly). Returns the number
    merged."""
    merged = 0
    for mod in list(root.modules()):
        for name, child in list(mod._modules.items()):
            if not isinstance(child, LoRALinear):
                continue
            base = child.base
            if type(base) is not nn.Linear:
                raise ValueError(
                    "merge_lora_tree: quantized base weights cannot absorb "
                    "the LoRA delta without a dequant/requant round-trip; "
                    "serve the adapter dict directly (mm dispatches it)."
                )
            delta = child.lora_a @ child.lora_b  # [in, out]
            w = base.weight
            merged_w = (w.T + delta * child.lora_s.to(delta.dtype)).to(w.dtype)
            w.copy_(merged_w.T)
            setattr(mod, name, base)
            merged += 1
    return merged


def lora_trainable_mask(root: nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable} over ``root.named_parameters()``: True
    only on the adapters' ``lora_a`` / ``lora_b`` (the base weights and the
    scales stay frozen). Apply with ``models/pi0/trainable.apply_mask``."""
    return {
        name: name.endswith((".lora_a", ".lora_b"))
        for name, _ in root.named_parameters()
    }


# ---------------------------------------------------------------------------
# PEFT adapter directories (OpenVLA's LLM)
# ---------------------------------------------------------------------------

# JAX's weight key -> (the PEFT block, the projection's module name)
_PEFT_NAME_MAP = {
    "q_w": ("self_attn", "q_proj"), "k_w": ("self_attn", "k_proj"),
    "v_w": ("self_attn", "v_proj"), "o_w": ("self_attn", "o_proj"),
    "gate_w": ("mlp", "gate_proj"), "up_w": ("mlp", "up_proj"),
    "down_w": ("mlp", "down_proj"),
}
_PEFT_KEY = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight")
# a factor's projection coefficient <W, d> / <d, d> inside this band on
# every sampled factor means the base already holds the delta
MERGED_BAND = (0.6, 1.4)

# (projection module name, layer) -> the base weight as an [in, out] view
WeightOf = Callable[[str, int], Optional[torch.Tensor]]


def _read_peft(adapter_dir: str) -> Tuple[float, Dict[str, Dict[int, Dict[str, torch.Tensor]]]]:
    """(scale = lora_alpha / r, {projection: {layer: {"A": [r, in], "B":
    [out, r]}}} in fp32) of a PEFT directory."""
    from blurr_tpu_torch.models.pi0.checkpoint import read_safetensors

    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    scale = float(acfg.get("lora_alpha", 16)) / float(acfg.get("r", 16))
    tensors: Dict[str, torch.Tensor] = {}
    st = os.path.join(adapter_dir, "adapter_model.safetensors")
    pt = os.path.join(adapter_dir, "adapter_model.bin")
    if os.path.exists(st):
        tensors = read_safetensors(st)
    elif os.path.exists(pt):
        tensors = torch.load(pt, map_location="cpu")
    if not tensors:
        raise FileNotFoundError(f"no adapter weights in {adapter_dir}")
    per: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    for k, v in tensors.items():
        m = _PEFT_KEY.search(k)
        if m:
            per.setdefault(m.group(2), {}).setdefault(int(m.group(1)), {})[m.group(3)] = v.float()
    return scale, per


def _delta(ab: Dict[str, torch.Tensor], scale: float) -> torch.Tensor:
    """scale * (B @ A)^T: the torch [out, in] product as JAX's [in, out]."""
    return scale * (ab["B"] @ ab["A"]).T


def _adapter_already_merged(weight_of: WeightOf, per: Dict, scale: float,
                            n_check: int = 6) -> bool:
    """Whether the base weights already hold the adapter's deltas. For each
    sampled (projection, layer) factor the projection coefficient
    c = <W, d> / <d, d> is ~1 when W = W_base + d and ~0 +- (|W|/|d|)
    cos(W, d) otherwise; that second term is unbounded for a small delta
    mildly aligned with W, so "merged" needs EVERY sampled coefficient in
    ``MERGED_BAND``. The sample goes round the projections and alternates
    the front and back of each one's layers, so a merged head with an
    unmerged tail is seen at both ends; zero deltas (B = 0) are skipped."""
    projs = [p for p in sorted(per) if weight_of(p, None) is not None]
    layers_of = {p: sorted(i for i, ab in per[p].items() if "A" in ab and "B" in ab)
                 for p in projs}
    candidates: List[Tuple[str, int]] = []
    rank = 0
    while len(candidates) < n_check and any(layers_of.values()):
        for p in projs:
            lst = layers_of[p]
            if not lst:
                continue
            candidates.append((p, lst.pop(0) if rank % 2 == 0 else lst.pop(-1)))
            if len(candidates) >= n_check:
                break
        rank += 1
    coeffs = []
    for proj, i in candidates:
        delta = _delta(per[proj][i], scale)
        denom = float((delta * delta).sum())
        if denom < 1e-12:
            continue
        w = weight_of(proj, i).float()
        coeffs.append(float((w * delta.to(w.device)).sum()) / denom)
    log.debug("adapter projection coefficients: %s", coeffs)
    lo, hi = MERGED_BAND
    return bool(coeffs) and all(lo < c < hi for c in coeffs)


def _weight_of(llama) -> WeightOf:
    """The [in, out] weight view of a projection of ``llama``: a
    ``models/openvla/llama.Llama`` (its ``nn.Linear``s) or a JAX-layout
    tree ({"layers": {"q_w": [L, in, out], ...}}). ``layer`` None asks
    whether the LLM has the projection at all. Raises ValueError on a
    projection that is not a plain linear (quantized or adapted)."""
    names = {proj: key for key, (_, proj) in _PEFT_NAME_MAP.items()}
    if isinstance(llama, nn.Module):
        def weight_of(proj, layer):
            if proj not in names:
                return None
            if layer is None:
                return True
            mod = getattr(llama.layers[layer], proj)
            if type(mod) is not nn.Linear:
                raise ValueError(f"layers.{layer}.{proj} is a {type(mod).__name__}: a PEFT "
                                 "adapter merges into fp weights only")
            return mod.weight.T
        return weight_of
    layers = llama["layers"]

    def weight_of(proj, layer):
        key = names.get(proj)
        if key is None or key not in layers:
            return None
        if layer is None:
            return True
        w = layers[key]
        if isinstance(w, dict):
            raise ValueError(f"layers.{key} is a {sorted(w)} dict: a PEFT adapter merges "
                             "into fp weights only")
        return w[layer]
    return weight_of


@torch.no_grad()
def merge_peft_adapter_into_llama(llama, adapter_dir: str):
    """Merge a PEFT LoRA directory into the LLM's fp weights in place
    (``_weight_of``: a module or a JAX-layout tree of tensors), each W +
    (alpha / r) * (B @ A)^T computed in fp32 and rounded to the weight's
    dtype, and return the LLM. Left as it is where the base already holds
    the delta (``_adapter_already_merged``, with a warning)."""
    scale, per = _read_peft(adapter_dir)
    weight_of = _weight_of(llama)
    if _adapter_already_merged(weight_of, per, scale):
        log.warning("Base weights already contain the LoRA adapter (projection coefficient "
                    "~1); skipping merge to avoid double-applying it (OFT snapshots may ship "
                    "pre-merged base weights alongside lora_adapter/).")
        return llama
    merged = 0
    for proj, by_layer in per.items():
        if weight_of(proj, None) is None:
            continue
        for i, ab in by_layer.items():
            if "A" not in ab or "B" not in ab:
                continue
            w = weight_of(proj, i)
            w.copy_((w.float() + _delta(ab, scale).to(w.device)).to(w.dtype))
            merged += 1
    log.info("Merged %d LoRA layer factors from %s", merged, adapter_dir)
    return llama


def maybe_merge_lora_adapter(llama, model_dir: str):
    """Merge ``<model_dir>/lora_adapter/`` where there is one (the
    reference's --use-lora auto); an adapter that cannot be merged logs a
    warning and the LLM stays unmerged."""
    adapter_dir = os.path.join(model_dir, "lora_adapter")
    if os.path.isdir(adapter_dir):
        try:
            return merge_peft_adapter_into_llama(llama, adapter_dir)
        except Exception as exc:
            log.warning("LoRA merge failed (%s); continuing without.", exc)
    return llama


def save_peft_adapter(llama: nn.Module, adapter_dir: str,
                      base_model_name: str = "openvla/openvla-7b",
                      module_prefix: str = "language_model.model.layers") -> int:
    """Write the ``LoRALinear`` factors of an OpenVLA LLM's layers as a PEFT
    ``lora_adapter/`` directory: ``adapter_model.safetensors`` (fp32, A as
    [r, in], B as [out, r]) and ``adapter_config.json`` (r, lora_alpha =
    layer 0's scale * r; a layer whose scale differs has it folded into its
    B, so the merge is exact). Returns the number of (projection, layer)
    factor pairs written."""
    from blurr_tpu_torch.models.pi0.checkpoint import save_safetensors

    tensors: Dict[str, torch.Tensor] = {}
    rank = alpha = None
    targets = []
    prefix = f"base_model.model.{module_prefix}"
    for _, (block, proj) in _PEFT_NAME_MAP.items():
        mods = [getattr(layer, proj, None) for layer in llama.layers]
        if not all(isinstance(m, LoRALinear) for m in mods):
            continue
        targets.append(proj)
        s0 = float(mods[0].lora_s)
        rank = mods[0].rank
        alpha = s0 * rank
        for i, m in enumerate(mods):
            a = m.lora_a.detach().float().cpu()
            b = m.lora_b.detach().float().cpu()
            s = float(m.lora_s)
            if s != s0:
                b = b * (s / s0)
            tensors[f"{prefix}.{i}.{block}.{proj}.lora_A.weight"] = a.T.contiguous()
            tensors[f"{prefix}.{i}.{block}.{proj}.lora_B.weight"] = b.T.contiguous()
    if not tensors:
        raise ValueError("no LoRA adapters found in the LLM's layers")
    os.makedirs(adapter_dir, exist_ok=True)
    save_safetensors(tensors, os.path.join(adapter_dir, "adapter_model.safetensors"))
    cfg = {
        "peft_type": "LORA",
        "base_model_name_or_path": base_model_name,
        "r": int(rank),
        "lora_alpha": alpha,
        "lora_dropout": 0.0,
        "bias": "none",
        "target_modules": sorted(set(targets)),
        "task_type": "CAUSAL_LM",
    }
    with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return len(tensors) // 2
