"""The port's int8 / cached-fp / w8a8 / w4a8 tiers and the int8 KV cache
(blurr_tpu_torch.ops.quant) against the JAX package's blurr_tpu.ops.quant on
the CPU.

Quantizer bytes must equal JAX's. The one allowed difference is a tie in the
w4a8 MSE clip search: the two frameworks sum a cell's squared error in
another order, so where two clips' errors agree to fp32 rounding either may
win; such a cell must show two errors equal to 1e-5 relative.

Matmul tolerances: w8a8 takes the same fp32 steps as JAX after an exact int32
dot, rtol 1e-6. The w4a8 product sums fp32 group terms where JAX on the CPU
takes one fp32 matmul of the dequantized weight: 1e-5 of the output's
largest magnitude. In bf16 the outputs may round one bf16 ulp apart: 1e-2
of it. The int8 weight-only product goes through the int8 kernel, which
rounds x to bf16: 1e-5 against the JAX package's own kernel (``int8_mm_nd``
in interpret mode), and JAX's own tolerance for that kernel against its XLA
dequant ``quant.mm`` (tests/test_pallas_attention.py: rtol 2e-2, atol 0.15).
The cached-fp product is the same fp32 matmul on both sides: 1e-6.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import pallas_int4_matmul as j_int4
from blurr_tpu.ops import quant as jq
from blurr_tpu.ops.pallas_int8_matmul import int8_mm_nd as j_int8_mm_nd
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import int4_matmul as t_int4
from blurr_tpu_torch.ops import quant as tq


def _weight(shape, seed=0, scale=0.05):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (256, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_quantizer_matches_jax_bytes(shape, dtype):
    jw = jnp.asarray(_weight(shape)).astype(dtype)
    want = jq.quantize_weight_w8a8(jw)
    got = tq.quantize_weight_w8a8(_t(jw.astype(jnp.float32), getattr(torch, dtype)))
    assert got["q8a"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8a"].numpy(), np.asarray(want["q8a"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def _cell_errors(w, q, s, g):
    """fp64 squared reconstruction error of every (group, column) cell."""
    k, n = w.shape
    d = q.astype(np.float64).reshape(k // g, g, n) * s[:, None, :] - w.reshape(k // g, g, n)
    return (d**2).sum(axis=1)


@pytest.mark.parametrize("k,n,group_size", [(64, 48, 512), (512, 300, 128),
                                             (1024, 200, 512), (256, 1500, 256)])
@pytest.mark.parametrize("mse_scale", [True, False])
def test_w4a8_quantizer_matches_jax_bytes(k, n, group_size, mse_scale):
    w = _weight((k, n), seed=k + n)
    want = jq.quantize_weight_w4a8(jnp.asarray(w), group_size, mse_scale)
    got = tq.quantize_weight_w4a8(_t(w), group_size, mse_scale)
    assert tuple(got["q4"].shape) == want["q4"].shape
    assert tuple(got["s"].shape) == want["s"].shape
    g = t_int4.pick_group_size(k, group_size)
    js, ts = np.asarray(want["s"]), got["s"].numpy()
    jqv = np.asarray(j_int4.unpack_int4_reference(
        j_int4.from_block_major(want["q4"])))[:, :n]
    tqv = t_int4.unpack_int4_reference(t_int4.from_block_major(got["q4"])).numpy()[:, :n]
    ties = js != ts  # [G, N] cells where another clip won
    rows = np.repeat(ties, g, axis=0)
    np.testing.assert_array_equal(tqv[~rows], jqv[~rows])
    if ties.any():
        assert mse_scale, "without the search every cell is the max-abs scale"
        ej, et = _cell_errors(w, jqv, js, g), _cell_errors(w, tqv, ts, g)
        np.testing.assert_allclose(et[ties], ej[ties], rtol=1e-5)
    if not ties.any():
        np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    # the padded columns are zero, as in JAX
    full = t_int4.unpack_int4_reference(t_int4.from_block_major(got["q4"]))
    assert (full[:, n:] == 0).all()


def test_w4a8_dequantized_weight_matches_jax():
    w = _weight((512, 300), seed=3)
    qd = jq.quantize_weight_w4a8(jnp.asarray(w), 256)
    got = tq._w4a8_deq(torch.from_numpy(np.array(qd["q4"])), _t(qd["s"]), 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._w4a8_deq(qd["q4"], qd["s"], 512)))


def _x(shape, dtype, seed=1):
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_quantized_mm_matches_jax(mode, clip, dtype):
    """x [2, 5, 256] through a 256 x 300 weight (N pads to 384 under w4a8,
    two 128-row groups), with and without the activation clip."""
    w = _weight((256, 300), seed=5)
    x = _x((2, 5, 256), dtype)
    if mode == "w8a8":
        jw = jq.quantize_weight_w8a8(jnp.asarray(w))
        tw = {"q8a": torch.from_numpy(np.array(jw["q8a"])), "s": _t(jw["s"])}
    else:
        jw = jq.quantize_weight_w4a8(jnp.asarray(w), 128)
        tw = {"q4": torch.from_numpy(np.array(jw["q4"])), "s": _t(jw["s"])}
    want = np.asarray(jq.mm(x, jw, clip).astype(jnp.float32))
    got = tq.mm(_t(x.astype(jnp.float32), getattr(torch, dtype)), tw, clip)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    rel = 1e-2 if dtype == "bfloat16" else (1e-6 if mode == "w8a8" else 1e-5)
    if mode == "w8a8" and dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=rel, atol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max())
    if clip is not None:  # the clamp bites: without it the answer moves
        assert not np.allclose(np.asarray(jq.mm(x, jw).astype(jnp.float32)), want)


def test_mm_plain_and_unported_weights():
    x = torch.randn(3, 8)
    w = torch.randn(8, 4)
    torch.testing.assert_close(tq.mm(x, w, activation_clip=0.1), x @ w)  # no clamp
    a, b = torch.randn(8, 2), torch.randn(2, 4)
    lora = {"w": w, "lora_a": a, "lora_b": b, "lora_s": torch.tensor(0.5)}
    torch.testing.assert_close(tq.mm(x, lora, activation_clip=0.1),
                               x @ w + ((x @ a) @ b) * 0.5)  # LoRA dicts dispatch
    with pytest.raises(ValueError, match=r"keys \['q', 'scale'\]"):
        tq.mm(x, {"q": w.to(torch.int8), "scale": w[0]})


def test_quantized_linears_from_linear():
    torch.manual_seed(0)
    lin = nn.Linear(64, 40)
    x = torch.randn(2, 3, 64)
    w8 = tq.W8A8Linear.from_linear(lin)
    assert tuple(w8.q8a.shape) == (64, 40) and w8.q8a.t().is_contiguous()
    want = tq.w8a8_mm(x, tq.quantize_weight_w8a8(lin.weight.t()), 0.5) + lin.bias
    torch.testing.assert_close(w8(x, 0.5), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no bias"):
        tq.W4A8Linear.from_linear(lin)
    lin = nn.Linear(64, 40, bias=False)
    w4 = tq.W4A8Linear.from_linear(lin, group_size=128)
    assert (w4.in_features, w4.out_features) == (64, 40)
    want = tq.w4a8_mm(x, tq.quantize_weight_w4a8(lin.weight.t(), 128))
    torch.testing.assert_close(w4(x), want, rtol=0, atol=0)
    assert tq.linear(lin, x, 0.5).shape == (2, 3, 40)  # nn.Linear: no clip


def _quantized_pair(vlm_cfg, action_cfg):
    """The tiny model quantized by JAX and by the port from the same fp32
    weights: (JAX fp tree, JAX quantized tree, port model), numpy trees."""
    # imported here, not at the top, so that the file (and its cuda tests)
    # still collects where an installed package named ``tests`` shadows
    # the repository's tests directory
    from tests.util import tiny_pi0_cfg

    cfg = tiny_pi0_cfg()
    cfg["vlm_quantization"] = vlm_cfg
    cfg["action_quantization"] = action_cfg
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    qp = jm.enable_vlm_quantization(jm.enable_action_quantization(params))
    tm.enable_action_quantization()
    tm.enable_vlm_quantization()
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, qp), tm


_MIX = {"q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
        "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj"}
_VIT = {"q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "out_w": "out_proj",
        "fc1_w": "fc1", "fc2_w": "fc2"}


def _check_w4a8_layer(w, leaf, mod):
    """The port's w4a8 bytes for one layer against JAX's model path. JAX
    quantizes stacked weights under ``lax.map``, compiled, where XLA turns
    ``amax / 7.0`` into ``amax * fp32(1/7)``; the port divides, as JAX's
    ``quantize_weight_w4a8`` does when called by itself. So a cell that kept
    the max-abs scale may hold scales one ulp apart: each must be exactly
    its side's rounding, and the int4 values must agree everywhere else."""
    k, n = w.shape
    groups = leaf["s"].shape[0]
    g = k // groups
    amax = np.maximum(np.abs(w.reshape(groups, g, n)).max(axis=1), np.float32(1e-6))
    js, ts = leaf["s"], mod.s.numpy()
    apart = js != ts
    np.testing.assert_array_equal(js[apart], amax[apart] * np.float32(1 / 7.0))
    np.testing.assert_array_equal(ts[apart], amax[apart] / np.float32(7.0))
    n_pad = mod.q4.shape[0] * mod.q4.shape[2]
    rows = torch.from_numpy(np.pad(np.repeat(apart, g, axis=0), ((0, 0), (0, n_pad - n))))
    unpack = lambda q: t_int4.unpack_int4_reference(t_int4.from_block_major(q))
    assert torch.equal(unpack(torch.from_numpy(np.array(leaf["q4"])))[~rows], unpack(mod.q4)[~rows])


@pytest.mark.parametrize("vlm,action", [
    ({"mode": "w8a8", "include_vision": True}, {"mode": "w8a8"}),
    ({"mode": "w4a8", "include_vision": True}, {"mode": "w4a8", "group_size": 128}),
    ({"mode": "w4a8", "int8_keys": ["down_w", "o_w"]},
     {"mode": "w4a8", "int8_keys": ["gate_w"]}),
])
def test_model_quantizers_match_jax_bytes(vlm, action):
    """enable_action_quantization / enable_vlm_quantization quantize every
    layer as the JAX methods do (group_size, int8_keys, include_vision), and
    leave the encoders, projector and embedding fp."""
    fp, tree, tm = _quantized_pair(vlm, action)
    for name in ("vlm", "action"):
        for i, layer in enumerate(tm.joint[name].layers):
            for key, attr in _MIX.items():
                leaf, mod = tree["joint"][name][key], getattr(layer, attr)
                if "q4" in leaf:
                    assert isinstance(mod, tq.W4A8Linear)
                    layer_leaf = {"q4": leaf["q4"][i], "s": leaf["s"][i]}
                    _check_w4a8_layer(fp["joint"][name][key][i], layer_leaf, mod)
                else:
                    assert isinstance(mod, tq.W8A8Linear)
                    np.testing.assert_array_equal(mod.q8a.numpy(), leaf["q8a"][i])
                    np.testing.assert_array_equal(mod.s.numpy(), leaf["s"][i])
    vision = vlm.get("include_vision", False)
    for i, layer in enumerate(tm.vision_tower.layers):
        for key, attr in _VIT.items():
            leaf, mod = tree["siglip"]["layers"][key], getattr(layer, attr)
            assert isinstance(mod, tq.W8A8Linear) == vision
            if vision:
                np.testing.assert_array_equal(mod.q8a.numpy(), leaf["q8a"][i])
                np.testing.assert_array_equal(mod.s.numpy(), leaf["s"][i])
    for mod in (tm.action_encoder_w1, tm.proprio_encoder, tm.action_decoder,
                tm.multi_modal_projector, tm.vision_tower.patch_embedding):
        assert type(mod) is nn.Linear
    assert tm.joint["proprio"] is tm.joint["action"]


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (7, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantizer_matches_jax_bytes(shape, dtype):
    """{"q","s"} equal JAX's bytes, and the cached-fp {"fp"} copy equals
    JAX's bf16 copy."""
    jw = jnp.asarray(_weight(shape)).astype(dtype)
    tw = _t(jw.astype(jnp.float32), getattr(torch, dtype))
    want = jq.quantize_weight_int8(jw)
    got = tq.quantize_weight_int8(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    want_fp = jq.quantize_weight_int8(jw, cache_fp_dtype=jnp.bfloat16)["fp"]
    got_fp = tq.quantize_weight_int8(tw, torch.bfloat16)
    assert set(got_fp) == {"fp"} and got_fp["fp"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got_fp["fp"].float().numpy(),
                                  np.asarray(want_fp.astype(jnp.float32)))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_kv_int8_matches_jax(clip):
    """A [L, B, H, S, D] cache (one layer of the port's is [B, H, S, D]): the
    same int8 values and per-(batch, head) scales, taken after the clip, and
    the same dequantized values in bf16 and fp32."""
    kv = np.random.RandomState(4).randn(2, 2, 3, 9, 16).astype(np.float32) * 1.5
    want_q, want_s = jq.quantize_kv_int8(jnp.asarray(kv), clip)
    got_q, got_s = tq.quantize_kv_int8(_t(kv), clip)
    assert got_q.dtype == torch.int8 and tuple(got_s.shape) == (2, 2, 3, 1, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = np.asarray(jq.dequantize_kv(want_q, want_s, jd).astype(jnp.float32))
        got = tq.dequantize_kv(got_q, got_s, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), want)
    if clip is not None:  # the clip bites: the scale is clip / 127 everywhere
        np.testing.assert_array_equal(got_s.numpy(), np.float32(1.0) / np.float32(127.0))


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mm_matches_jax(dtype, clip):
    """x [2, 5, 96] through a 96 x 130 {"q","s"} weight: against JAX's
    int8_mm_nd (interpret mode) after the clip at 1e-5 (bf16: one bf16
    rounding), and against JAX's quant.mm at its own tolerance for the kernel."""
    w = _weight((96, 130), seed=6, scale=0.3)
    x = _x((2, 5, 96), dtype)
    jw = jq.quantize_weight_int8(jnp.asarray(w))
    tw = {"q": torch.from_numpy(np.array(jw["q"])), "s": _t(jw["s"])}
    got = tq.mm(_t(x.astype(jnp.float32), getattr(torch, dtype)), tw, clip)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 5, 130)
    got = got.float().numpy()
    xc = x if clip is None else jnp.clip(x, -clip, clip)
    kernel = np.asarray(j_int8_mm_nd(xc, jw, interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - kernel) <= 2.0**-8 * np.abs(kernel) + 1e-6).all()
    xla = np.asarray(jq.mm(x, jw, clip).astype(jnp.float32))
    np.testing.assert_allclose(got, xla, rtol=2e-2, atol=0.15)
    if clip is not None:  # the clamp bites: without it the answer moves
        assert not np.allclose(np.asarray(jq.mm(x, jw).astype(jnp.float32)), xla)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_cached_fp_mm_matches_jax(clip):
    """{"fp"}: the bf16 copy cast to x's fp32, after the clip, as JAX's mm."""
    w = _weight((96, 130), seed=8, scale=0.3)
    x = _x((2, 5, 96), "float32")
    jw = jq.quantize_weight_int8(jnp.asarray(w), cache_fp_dtype=jnp.bfloat16)
    tw = {"fp": _t(jw["fp"].astype(jnp.float32), torch.bfloat16)}
    want = np.asarray(jq.mm(x, jw, clip))
    got = tq.mm(_t(x), tw, clip)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int8_linears_from_linear():
    torch.manual_seed(0)
    lin = nn.Linear(64, 40)
    x = torch.randn(2, 3, 64)
    m8 = tq.Int8Linear.from_linear(lin)
    assert tuple(m8.q.shape) == (64, 40) and m8.q.is_contiguous()
    assert m8.bias is lin.bias
    want = tq.int8_mm(x, tq.quantize_weight_int8(lin.weight.t()), 0.5) + lin.bias
    torch.testing.assert_close(m8(x, 0.5), want, rtol=0, atol=0)
    fp = tq.CachedFpLinear.from_linear(lin)
    assert fp.fp.dtype == torch.bfloat16 and tuple(fp.fp.shape) == (64, 40)
    want = x.clamp(-0.5, 0.5) @ fp.fp.float() + lin.bias
    torch.testing.assert_close(fp(x, 0.5), want, rtol=0, atol=0)
    assert tq.linear(m8, x, 0.5).shape == tq.linear(fp, x, 0.5).shape == (2, 3, 40)


@pytest.mark.parametrize("cache_fp", [False, True])
def test_int8_model_quantizer_matches_jax_bytes(cache_fp):
    """enable_action_quantization under int8 quantizes the action mixture
    and the action encoder as JAX does (q/s bytes, or the bf16 copy), and
    leaves the proprio encoder, the action decoder and the vlm mixture fp."""
    fp, tree, tm = _quantized_pair(
        {}, {"mode": "int8", "cache_fp_weight": cache_fp})
    kind, keys = (tq.CachedFpLinear, ("fp",)) if cache_fp else (tq.Int8Linear, ("q", "s"))

    def same(mod, leaf):
        assert isinstance(mod, kind) and set(leaf) == set(keys)
        for key in keys:
            np.testing.assert_array_equal(getattr(mod, key).float().numpy(),
                                          leaf[key].astype(np.float32))

    for i, layer in enumerate(tm.joint["action"].layers):
        for key, attr in _MIX.items():
            leaf = tree["joint"]["action"][key]
            same(getattr(layer, attr), {k: v[i] for k, v in leaf.items()})
    for n in (1, 2, 3):
        same(getattr(tm, f"action_encoder_w{n}"), tree["action_encoder"][f"w{n}"])
    for mod in (tm.proprio_encoder, tm.action_decoder, tm.joint["vlm"].layers[0].q_proj):
        assert type(mod) is nn.Linear
    assert tm.joint["proprio"] is tm.joint["action"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 17, 64])
@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_quantized_mm_on_cuda_equals_cpu(cuda_device, mode, m):
    """The card runs the same steps as the CPU: exact int32 products (rows
    padded to 32 for cuBLASLt's int8 product at M <= 16, K2 for w4a8) and
    the same fp32 elementwise ops, true divisions included; 1e-6 relative
    bounds any difference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lin = nn.Linear(1152, 4304, bias=False)
    with torch.no_grad():
        lin.weight.copy_(_t(_weight((4304, 1152), seed=m)))
    mod = (tq.W8A8Linear.from_linear(lin) if mode == "w8a8"
           else tq.W4A8Linear.from_linear(lin))
    x = _t(np.random.RandomState(m).randn(m, 1152) * 2)
    want = mod(x, 1.5)
    got = mod.to(cuda_device)(x.to(cuda_device), 1.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_mm_on_cuda_equals_cpu(cuda_device, dtype, m):
    """The int8 kernel on the card against its plain version on the CPU,
    through Int8Linear with the clip: 1e-5 of the largest output in fp32,
    one bf16 rounding of each output in bf16."""
    lin = nn.Linear(1024, 4096, bias=False)
    with torch.no_grad():
        lin.weight.copy_(_t(_weight((4096, 1024), seed=m)))
    mod = tq.Int8Linear.from_linear(lin)
    x = _t(np.random.RandomState(m).randn(m, 1024) * 2, dtype)
    want = mod(x, 1.5).float()
    got = mod.to(cuda_device)(x.to(cuda_device), 1.5).float().cpu()
    torch.cuda.synchronize()
    bound = 1e-5 * want.abs().max() + (2.0**-8 * want.abs() if dtype == torch.bfloat16 else 0)
    assert ((got - want).abs() <= bound).all()
