"""The port's LoRA adapters (``blurr_tpu_torch.ops.lora``) and the LoRA
dicts of ``ops.quant.mm`` against the JAX package's ``blurr_tpu.ops.lora``
and ``quant.mm`` on the CPU.

``mm`` of a LoRA dict over a plain, w8a8 or w4a8 base equals JAX's within
1e-5 of the output's largest magnitude (the w4a8 base: JAX dequantizes,
the port sums fp32 group terms), with the activation clip on the base only.
``LoRALinear`` computes the same as the dict. ``inject_lora_tree`` adapts
the same weights as JAX's for each scope's subtrees and targets, with A's
scale 1/sqrt(r), B zero and s = alpha/r; ``merge_lora_tree`` folds the
adapters as JAX's does (1e-6) and refuses a quantized base; JAX's adapter
trees copy into the port (``load_jax_params``) byte for byte.
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import lora as j_lora
from blurr_tpu.ops import quant as jq
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import lora as t_lora
from blurr_tpu_torch.ops import quant as tq
from tests.util import tiny_pi0_cfg

MM_TOL = 1e-5
CLIP = 0.5


def _lora_dict(base, din=64, dout=24, r=4, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(din, dout) * 0.1).astype(np.float32)
    d = {"w": {"plain": lambda: jnp.asarray(w), "w8a8": lambda: jq.quantize_weight_w8a8(w),
               "w4a8": lambda: jq.quantize_weight_w4a8(jnp.asarray(w))}[base](),
         "lora_a": jnp.asarray(rng.randn(din, r).astype(np.float32)),
         "lora_b": jnp.asarray(rng.randn(r, dout).astype(np.float32) * 0.1),
         "lora_s": jnp.asarray(0.5, jnp.float32)}
    return d


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("base", ["plain", "w8a8", "w4a8"])
@pytest.mark.parametrize("clip", [None, CLIP])
def test_mm_lora_dict_matches_jax(base, clip):
    d = _lora_dict(base)
    x = np.random.RandomState(1).randn(3, 5, 64).astype(np.float32)
    want = np.asarray(jq.mm(jnp.asarray(x), d, clip))
    got = tq.mm(torch.from_numpy(x), _t(d), clip).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MM_TOL * np.abs(want).max())
    if clip is not None and base != "plain":  # the clip bites the base only
        no_clip_branch = tq.mm(torch.from_numpy(x), {**_t(d), "lora_a": _t(d["lora_a"]) * 0},
                               clip)
        delta = (torch.from_numpy(x) @ _t(d["lora_a"])) @ _t(d["lora_b"]) * 0.5
        torch.testing.assert_close(torch.from_numpy(got), no_clip_branch + delta)


@pytest.mark.parametrize("base", ["plain", "w8a8", "w4a8"])
def test_lora_linear_matches_the_dict(base):
    """LoRALinear over an nn.Linear (with a bias, added after the adapter),
    a W8A8Linear or a W4A8Linear equals mm of the dict (+ bias)."""
    d = _t(_lora_dict(base))
    if base == "plain":
        mod = nn.Linear(64, 24)
        with torch.no_grad():
            mod.weight.copy_(d["w"].T)
    else:
        mod = (tq.W8A8Linear if base == "w8a8" else tq.W4A8Linear)(**d["w"])
    lin = t_lora.LoRALinear(mod, d["lora_a"], d["lora_b"], d["lora_s"])
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(2))
    want = tq.mm(x, d, CLIP)
    if base == "plain":
        want = want + mod.bias
    torch.testing.assert_close(tq.linear(lin, x, CLIP), want, rtol=1e-6, atol=1e-6)
    assert lin.bias is getattr(mod, "bias", None)
    assert lin.lora_s.dtype == torch.float32 and lin.lora_s is not d["lora_s"]


@functools.lru_cache(maxsize=None)
def _jax_canonical():
    cfg = tiny_pi0_cfg()
    jm = JPiZero(cfg)
    return cfg, jm.canonicalize_tied_weights(
        jm.tie_action_proprio_weights(jax.jit(jm.init_params)(jax.random.PRNGKey(0))))


def _jax_tree():
    """(tiny cfg, JAX's canonical tied tree): a fresh copy of the cached
    dicts, the arrays shared."""
    cfg, params = _jax_canonical()
    return cfg, jax.tree.map(lambda a: a, params)


def _adapted_jax(tree, prefix=""):
    """{path: (a shape, b shape, s)} of every adapter dict of a JAX tree."""
    out = {}
    if j_lora.is_lora_dict(tree):
        return {prefix: (tree["lora_a"].shape, tree["lora_b"].shape, np.asarray(tree["lora_s"]))}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_adapted_jax(v, f"{prefix}.{k}" if prefix else k))
    return out


@pytest.mark.parametrize("targets", [("q_w", "v_w"), ("q_w", "k_w", "v_w", "o_w", "gate_w",
                                                       "up_w", "down_w", "out_w", "fc1_w",
                                                       "fc2_w")])
@pytest.mark.parametrize("quant", [None, "w4a8"])
def test_inject_adapts_what_jax_adapts(targets, quant):
    """Each scope's subtrees (SigLIP, projector, the two mixtures) with
    JAX's targets: the same weights adapted, A [in, r] with std 1/sqrt(r)
    (fp32 over a quantized base), B zero, s = alpha / r."""
    rank, alpha = 4, 8.0
    cfg = tiny_pi0_cfg()  # the structure alone: shapes traced, nothing computed
    jm = JPiZero(cfg)
    params = jax.eval_shape(lambda: jm.canonicalize_tied_weights(
        jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))))
    if quant:
        params = jax.eval_shape(lambda p: {**p, "joint": {
            **p["joint"], **{m: jq.quantize_mixture_w4a8(p["joint"][m])
                             for m in ("vlm", "action")}}}, params)
    jax_adapted = {}
    for path, sub in (("siglip", params["siglip"]), ("projector", params["projector"]),
                      ("vlm", params["joint"]["vlm"]), ("action", params["joint"]["action"])):
        for k, (a, b, s) in _adapted_jax(
                j_lora.inject_lora_tree(sub, jax.random.PRNGKey(1), rank, targets, alpha),
                path).items():
            jax_adapted[k] = (a[-2:], b[-2:], float(np.ravel(s)[0]), a[0] if len(a) > 2 else 1)
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    if quant:
        for m in ("vlm", "action"):
            tq.quantize_mixture_w4a8(model.joint[m].layers)
    g = torch.Generator().manual_seed(1)
    port = {}
    for path, mod in (("siglip", model.vision_tower), ("projector", model.multi_modal_projector),
                      ("vlm", model.joint["vlm"]), ("action", model.joint["action"])):
        t_lora.inject_lora_tree(mod, g, rank, targets, alpha)
        for name, sub in mod.named_modules():
            if isinstance(sub, t_lora.LoRALinear):
                key = {v: k for k, v in t_lora.TARGET_ATTRS.items()}[name.rsplit(".", 1)[-1]]
                where = f"{path}.layers.{key}"
                a, b = sub.lora_a, sub.lora_b
                assert torch.count_nonzero(b) == 0 and a.dtype == torch.float32
                assert isinstance(sub.base, tq.W4A8Linear) == (quant is not None and
                                                              path in ("vlm", "action"))
                n = port.get(where, (None, None, None, 0))[3] + 1
                port[where] = (tuple(a.shape), tuple(b.shape), float(sub.lora_s), n)
    jax_adapted = {k.replace(".layers", "").replace(".", ".layers.", 1)
                   if k.startswith("siglip") else k.replace(".", ".layers.", 1): v
                   for k, v in jax_adapted.items()}
    assert port == jax_adapted
    a = torch.cat([m.lora_a.flatten() for m in model.modules()
                   if isinstance(m, t_lora.LoRALinear)])
    assert abs(float(a.std()) * rank**0.5 - 1) < 0.1


def test_jax_adapters_load_byte_for_byte_and_merge_as_jax():
    """A JAX tree with adapters (non-zero B) over plain weights, copied into
    the port: A, B, s the same bytes; merged, the plain weights JAX's
    merge_lora_tree gives, within 1e-6."""
    cfg, params = _jax_tree()
    targets = ("q_w", "v_w", "fc1_w")
    rng = np.random.RandomState(4)
    params = dict(params)
    params["joint"] = dict(params["joint"])
    params["siglip"] = j_lora.inject_lora_tree(params["siglip"], jax.random.PRNGKey(2), 2,
                                               targets, 4.0)
    for m in ("vlm", "action"):
        params["joint"][m] = j_lora.inject_lora_tree(params["joint"][m], jax.random.PRNGKey(3), 2,
                                                     targets, 4.0)

    def nonzero_b(t):
        if j_lora.is_lora_dict(t):
            return {**t, "lora_b": jnp.asarray(rng.randn(*t["lora_b"].shape), jnp.float32)}
        return {k: nonzero_b(v) for k, v in t.items()} if isinstance(t, dict) else t

    params = nonzero_b(params)
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    t_lora.inject_lora_tree(model.vision_tower, g, 2, targets, 4.0)
    for m in ("vlm", "action"):
        t_lora.inject_lora_tree(model.joint[m], g, 2, targets, 4.0)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    q = model.joint["vlm"].layers[1].q_proj
    jq_ = params["joint"]["vlm"]["q_w"]
    assert np.array_equal(q.lora_a.detach().numpy(), np.asarray(jq_["lora_a"][1]))
    assert np.array_equal(q.lora_b.detach().numpy(), np.asarray(jq_["lora_b"][1]))
    assert float(q.lora_s) == 2.0
    merged = j_lora.merge_lora_tree(params)
    # SigLIP q, v, fc1 in 2 layers; the vlm and action mixtures q, v in 3
    assert t_lora.merge_lora_tree(model) == 3 * 2 + 2 * 3 + 2 * 3
    fresh = PiZero(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(fresh, jax.tree.map(np.asarray, merged))
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_load_refuses_a_structure_mismatch():
    cfg, params = _jax_tree()
    params["joint"]["vlm"] = j_lora.inject_lora_tree(params["joint"]["vlm"],
                                                     jax.random.PRNGKey(0), 2)
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="LoRA dict"):
        load_jax_params(model, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("quant", [tq.quantize_mixture_w8a8, tq.quantize_mixture_w4a8])
def test_merge_refuses_a_quantized_base(quant):
    cfg = tiny_pi0_cfg()
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    quant(model.joint["action"].layers)
    t_lora.inject_lora_tree(model.joint["action"], torch.Generator().manual_seed(1), 2)
    with pytest.raises(ValueError, match="quantized base"):
        t_lora.merge_lora_tree(model)


def test_trainable_mask_and_quantizers_skip_adapters():
    """Only lora_a / lora_b train; a quantizer run after injection leaves
    the adapters (and their bases) as they are, as JAX's skip dicts."""
    cfg = tiny_pi0_cfg()
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    t_lora.inject_lora_tree(model.joint["vlm"], torch.Generator().manual_seed(1), 2)
    mask = t_lora.lora_trainable_mask(model)
    assert sorted({n.rsplit(".", 1)[-1] for n, m in mask.items() if m}) == ["lora_a", "lora_b"]
    assert sum(mask.values()) == 2 * 2 * cfg.joint.config.num_hidden_layers
    tq.quantize_mixture_w4a8(model.joint["vlm"].layers)
    layer = model.joint["vlm"].layers[0]
    assert isinstance(layer.q_proj, t_lora.LoRALinear) and type(layer.q_proj.base) is nn.Linear
    assert isinstance(layer.k_proj, tq.W4A8Linear)
    p = t_lora.init_lora_params(torch.Generator().manual_seed(0), 8, 5, 2)
    assert p["a"].shape == (8, 2) and torch.count_nonzero(p["b"]) == 0
