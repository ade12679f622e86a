"""The port's quantizer of a loaded decoder under JAX's name,
``quantize_llama_streaming`` (``blurr_tpu_torch/models/openvla/llama.py``:
``quantize_llama_w8a8`` / ``_w4a8`` by mode), against JAX's memory-bounded
one on a tiny LLaMA with an fp head and a tiny Qwen2 with a tied head,
w8a8 and w4a8, on the same fp32 weights.

JAX quantizes the stacked layer weights under ``lax.map``, compiled, where
XLA turns ``amax / 127`` and ``amax / 7`` into products with the
reciprocal: a scale may sit one ulp from the port's quotient. Each scale
must be exactly one side's rounding and the int8 / int4 values must agree
wherever the scales do (``_check_w8a8_layer``; ``_check_w4a8_layer`` of
``tests/test_torch_quant.py``). The head is quantized by itself on both
sides: bit for bit. The result must also be bit for bit that of the
layer-by-layer order (``ops.quant``'s mixture quantizers, then the head),
and no replaced fp weight may survive it.
"""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from blurr_tpu.models.openvla import llama as j_llama
from blurr_tpu_torch.models.openvla import llama as t_llama
from blurr_tpu_torch.ops.quant import quantize_mixture_w4a8, quantize_mixture_w8a8

LINEARS = {"q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
           "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj"}
IN_PLACE = {"w8a8": t_llama.quantize_llama_w8a8, "w4a8": t_llama.quantize_llama_w4a8}
LAYER_ORDER = {"w8a8": quantize_mixture_w8a8, "w4a8": quantize_mixture_w4a8}
KEYS = {"w8a8": ("q8a", "s"), "w4a8": ("q4", "s")}


def _pair(name):
    from tests.test_torch_openvla import _pair as pair

    return pair(name)


def _check_w8a8_layer(w, leaf, mod):
    """One layer's w8a8 bytes against JAX's lax.map path: scales apart only
    as amax x fp32(1/127) against amax / 127, the values equal in every
    column whose scales agree."""
    amax = np.maximum(np.abs(w).max(axis=0), np.float32(1e-6))
    js, ts = np.asarray(leaf["s"]), mod.s.numpy()
    apart = js != ts
    np.testing.assert_array_equal(js[apart], amax[apart] * np.float32(1 / 127.0))
    np.testing.assert_array_equal(ts[apart], amax[apart] / np.float32(127.0))
    np.testing.assert_array_equal(np.asarray(leaf["q8a"])[:, ~apart], mod.q8a.numpy()[:, ~apart])


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
@pytest.mark.parametrize("name", ["tiny", "tiny_minivla"])
def test_streaming_matches_jax_and_the_in_place_quantizer(name, mode):
    from tests.test_torch_quant import _check_w4a8_layer

    _, params, tm = _pair(name)
    fp = jax.tree.map(np.asarray, params["llama"])
    tree = jax.tree.map(np.asarray, j_llama.quantize_llama_streaming(
        jax.tree.map(jnp.array, fp), mode))
    other = copy.deepcopy(tm.llama)
    t_llama.quantize_llama_streaming(tm.llama, mode)
    LAYER_ORDER[mode](other.layers)  # layer by layer, each layer's q ... down
    IN_PLACE[mode](other)  # the head alone: the layers are swapped already
    kind = t_llama.W8A8Linear if mode == "w8a8" else t_llama.W4A8Linear
    for i, layer in enumerate(tm.llama.layers):
        for key, attr in LINEARS.items():
            mod = getattr(layer, attr)
            assert isinstance(mod, kind)
            leaf = {k: tree["layers"][key][k][i] for k in KEYS[mode]}
            check = _check_w8a8_layer if mode == "w8a8" else _check_w4a8_layer
            check(fp["layers"][key][i], leaf, mod)
    for key in KEYS[mode]:  # the head (a tied one materialized from the embedding)
        np.testing.assert_array_equal(getattr(tm.llama.lm_head, key).numpy(),
                                      tree["lm_head"][key])
    ours = dict(tm.llama.named_buffers())
    theirs = dict(other.named_buffers())
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert tm.llama.embed_tokens.dtype == torch.float32  # the gather stays fp


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
@pytest.mark.parametrize("name", ["tiny", "tiny_minivla"])
def test_streaming_keeps_no_fp_weight(name, mode):
    """A weak reference to each replaced fp weight is dead afterwards: the
    caching allocator can reuse its bytes."""
    _, _, tm = _pair(name)
    refs = [weakref.ref(mod.weight) for mod in tm.llama.modules() if type(mod) is nn.Linear]
    assert len(refs) == 7 * len(tm.llama.layers) + (0 if name == "tiny_minivla" else 1)
    t_llama.quantize_llama_streaming(tm.llama, mode)
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(type(m) is nn.Linear for m in tm.llama.modules())


def test_streaming_takes_the_smallest_kinds_first(monkeypatch):
    """q, k, v, o (64 x 64, k and v 64 x 32) before gate / up / down: the
    order JAX's sort by size gives, each kind over every layer, the head
    last."""
    _, _, tm = _pair("tiny")
    order = []
    real = t_llama.W4A8Linear.from_linear

    def record(lin, *a, **kw):
        order.append(tuple(lin.weight.shape))
        return real(lin, *a, **kw)

    monkeypatch.setattr(t_llama.W4A8Linear, "from_linear", staticmethod(record))
    t_llama.quantize_llama_streaming(tm.llama, "w4a8")
    sizes = [a * b for a, b in order]
    assert sizes[:-1] == sorted(sizes[:-1]) and order[-1] == (32064, 64)
    assert len(order) == 7 * len(tm.llama.layers) + 1


def test_streaming_refuses_an_unknown_mode():
    _, _, tm = _pair("tiny")
    with pytest.raises(ValueError, match="mode"):
        t_llama.quantize_llama_streaming(tm.llama, "int8")
