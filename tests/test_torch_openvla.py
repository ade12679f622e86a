"""The port's OpenVLA family (``blurr_tpu_torch/models/openvla``) against the
JAX package on the CPU: the ViT towers in both position-table layouts, the
fused and prismatic vision features, the LLaMA / Qwen2 decoder's forward,
logits, greedy and Jacobi decoding (ragged batches, warm starts, the
``num_iters`` ladder), ``predict_action`` with unnormalization, OFT with and
without proprio, and the w8a8 / w4a8 tiers with JAX's quantized trees
carried across.

JAX's tree (``init_params``, every float leaf perturbed from a numpy seed
so biases, LayerScale and prefix tokens are not zero) goes into the port
with ``load_jax_params``; inputs come from numpy seeds. fp32 throughout:
hidden states, logits and continuous actions within TOL (the same fp32
formulas summed in another order), tokens equal. JAX's w4a8 runs once
through its dequantizing XLA route and once through its Pallas kernel in
interpret mode (``BLURR_INT4_FORCE=interpret``); the port runs its kernel's
plain version (exact group sums) on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.openvla import llama as j_llama
from blurr_tpu.models.openvla import model as j_model
from blurr_tpu.models.openvla import vit as j_vit
from blurr_tpu_torch.models.openvla import llama as t_llama
from blurr_tpu_torch.models.openvla import model as t_model
from blurr_tpu_torch.models.openvla import vit as t_vit
from blurr_tpu_torch.models.openvla.checkpoint import llama_pairs, load_jax_params, vit_pairs
from blurr_tpu_torch.models.pi0.checkpoint import copy_pairs

TOL = 1e-5
NORM = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.2] * 7,
                                   "mask": [True] * 6 + [False]}}}
SPECS = ("tiny", "tiny_minivla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed=0, scale=0.05):
    """Every float leaf plus N(0, scale^2) noise (int8 leaves untouched)."""
    rng = np.random.RandomState(seed)

    def f(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return a
        return (a + scale * rng.randn(*a.shape)).astype(a.dtype)

    return jax.tree.map(f, tree)


def _pair(name="tiny", oft=False, use_proprio=False, quant=None):
    """(JAX model, JAX params as jnp, port model) on the same fp32 weights;
    ``quant`` quantizes JAX's LLM and the port's the same way before the
    copy."""
    spec = getattr(j_model.OpenVLASpec, name)()
    tspec = getattr(t_model.OpenVLASpec, name)()
    if oft:
        jm = j_model.OpenVLAOFT(spec, NORM, chunk_len=2, use_proprio=use_proprio,
                                proprio_dim=5)
        tm = t_model.OpenVLAOFT(tspec, NORM, 2, use_proprio, 5, device="cpu",
                                dtype=torch.float32)
    else:
        jm = j_model.OpenVLA(spec, NORM)
        tm = t_model.OpenVLA(tspec, NORM, device="cpu", dtype=torch.float32)
    params = _perturb(_np(jm.init_params(jax.random.PRNGKey(0))))
    if quant is not None:
        qfn = {"w8a8": j_llama.quantize_llama_w8a8, "w4a8": j_llama.quantize_llama_w4a8}[quant]
        params["llama"] = _np(qfn(jax.tree.map(jnp.asarray, params["llama"])))
        {"w8a8": t_llama.quantize_llama_w8a8, "w4a8": t_llama.quantize_llama_w4a8}[quant](tm.llama)
    load_jax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


def _inputs(model, batch=1, n_text=8, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 31000, (batch, n_text)).astype(np.int32)
    ids[:, 0] = 1
    ids[:, -1] = j_model.EMPTY_TOKEN
    c = 6 if model.spec.use_fused_vision else 3
    px = rng.rand(batch, c, 28, 28).astype(np.float32)
    return ids, px


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------

VIT_CASES = {
    # timm no_embed_class (DINOv2 reg4): the table covers the patches only
    "reg_no_embed_class": (j_vit.ViTSpec(32, 64, 3, 2, image_size=28, cls_token=True,
                                         reg_tokens=4, layerscale=True), None),
    # the same tower with an embed-class table ([cls] + patches): registers
    # go in after the table
    "reg_embed_class": (j_vit.ViTSpec(32, 64, 3, 2, image_size=28, cls_token=True,
                                      reg_tokens=4, layerscale=True), 5),
    "cls_embed_class": (j_vit.ViTSpec(32, 64, 2, 2, image_size=28, cls_token=True), None),
    "siglip": (j_vit.ViTSpec(48, 96, 3, 2, image_size=28), None),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vit_forward_matches_jax(case):
    """vit_forward in both position-table layouts, with and without class,
    register and LayerScale, feature_layer -2 (the last block neither
    stored nor run)."""
    jspec, pos_rows = VIT_CASES[case]
    params = _np(j_vit.init_vit_params(jax.random.PRNGKey(3), jspec))
    if pos_rows is not None:
        params["pos_embed"] = np.random.RandomState(4).randn(pos_rows, 32).astype(np.float32)
    params = _perturb(params, seed=5)
    tspec = t_vit.ViTSpec(**{f: getattr(jspec, f) for f in jspec.__dataclass_fields__})
    assert tspec.effective_num_layers == jspec.num_layers - 1
    vit = t_vit.ViT(tspec, device="cpu", dtype=torch.float32)
    copy_pairs(vit, vit_pairs(vit, params))
    px = np.random.RandomState(6).rand(2, 3, 28, 28).astype(np.float32)
    ref = j_vit.vit_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(px), jspec)
    out = vit(torch.from_numpy(px))
    assert out.shape == (2, 4, jspec.hidden_size)
    _close(out.detach(), ref)


@pytest.mark.parametrize("name", SPECS)
def test_vision_features_and_prompt_embeds_match_jax(name):
    """The fused DINOv2 + SigLIP stack with its 3-linear projector, and the
    prismatic SigLIP-only 2-linear projector; the [BOS] + patches + text
    prompt built on top."""
    jm, params, tm = _pair(name)
    ids, px = _inputs(tm, batch=2)
    ref = jm._build_prompt_embeds(params, jnp.asarray(ids), jnp.asarray(px))
    with torch.no_grad():
        out = tm._build_prompt_embeds(torch.from_numpy(ids).long(), torch.from_numpy(px))
    assert out.shape == (2, 1 + 4 + 7, tm.spec.llama.hidden_size)
    _close(out, ref)
    if name == "tiny":  # a 3-channel image feeds both towers
        ref3 = jm._vision_features(params, jnp.asarray(px[:, 3:]))
        with torch.no_grad():
            out3 = tm._vision_features(torch.from_numpy(px[:, 3:]))
        _close(out3, ref3)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPECS)
def test_forward_hidden_and_logits_match_jax(name):
    """A prefill with a padded column and a decode step at an offset: the
    hidden states, the cache and the logits (the tied head for MiniVLA)."""
    jm, params, tm = _pair(name)
    lp, spec = params["llama"], jm.spec.llama
    rng = np.random.RandomState(2)
    emb = (0.5 * rng.randn(2, 6, spec.hidden_size)).astype(np.float32)
    valid = np.ones((2, 6), np.int32)
    valid[1, 4:] = 0
    max_len = 8
    mask = j_llama.causal_prefill_mask(jnp.asarray(valid), max_len)
    pos = jnp.broadcast_to(jnp.arange(6)[None], (2, 6))
    cache = j_llama.alloc_cache(spec, 2, max_len, jnp.float32)
    h, cache = j_llama.forward(lp, spec, jnp.asarray(emb), pos, mask, cache, jnp.int32(0))
    tmask = t_llama.causal_prefill_mask(torch.from_numpy(valid), max_len)
    assert np.array_equal(tmask.numpy(), np.asarray(mask))
    tcache = t_llama.alloc_cache(tm.llama.spec, 2, max_len, torch.float32, "cpu")
    with torch.no_grad():
        th, tcache = tm.llama(torch.from_numpy(emb), torch.from_numpy(np.array(pos)),
                              tmask, tcache, 0)
        _close(th, h)
        _close(tcache[0], cache[0])
        _close(tm.llama.logits(th), j_llama.logits(lp, spec, h))
        # one decode step at column 6, row 1 at its own position 4 with its
        # pad columns masked
        step = emb[:, :1] * 0.7
        valid_cols = np.pad(valid.astype(bool), ((0, 0), (0, max_len - 6)), constant_values=True)
        m2 = jnp.asarray((np.arange(max_len) <= 6)[None, None] & valid_cols[:, None])
        p2 = jnp.asarray([[6], [4]])
        h2, cache = j_llama.forward(lp, spec, jnp.asarray(step), p2, m2, cache, jnp.int32(6))
        th2, tcache = tm.llama(torch.from_numpy(step), torch.from_numpy(np.array(p2)),
                               torch.from_numpy(np.array(m2)), tcache, 6)
        _close(th2, h2)
        _close(tcache[1], cache[1])
        _close(tm.llama.final_hidden(th2), j_llama.final_hidden(lp, spec, h2))


def test_llama_rms_norm_scales_after_the_downcast():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.bfloat16)
    w = torch.full((4,), 1.5, dtype=torch.bfloat16)
    ref = j_llama.llama_rms_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                 jnp.full((4,), 1.5, jnp.bfloat16), 1e-5)
    out = t_llama.llama_rms_norm(x, w, 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("name", SPECS)
def test_greedy_generate_matches_jax(name):
    jm, params, tm = _pair(name)
    ids, px = _inputs(tm)
    ref = np.asarray(jm.predict_action_tokens(params, jnp.asarray(ids), jnp.asarray(px)))
    out = tm.predict_action_tokens(ids, px)
    assert out.device.type == "cpu" and out.shape == (1, 7)
    np.testing.assert_array_equal(out.numpy(), ref)
    toks, logits = t_llama.greedy_generate(tm.llama, *tm._inputs(ids, px), 7,
                                           return_logits=True)
    assert torch.equal(toks, out) and torch.equal(logits.argmax(-1), out)


def _ragged(tm, seed=3):
    """Two prompts of 8 and 6 tokens, the second right-padded to 8."""
    ids, px = _inputs(tm, batch=2, seed=seed)
    am = np.ones_like(ids)
    ids[1, 5] = j_model.EMPTY_TOKEN
    ids[1, 6:] = 0
    am[1, 6:] = 0
    return ids, px, am


@pytest.mark.parametrize("name", SPECS)
def test_ragged_batch_matches_jax_and_solo_prompts(name):
    jm, params, tm = _pair(name)
    ids, px, am = _ragged(tm)
    ref = np.asarray(jm.predict_action_tokens_ragged(
        params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(am)))
    out = tm.predict_action_tokens_ragged(ids, px, am).numpy()
    np.testing.assert_array_equal(out, ref)
    for row, n in ((0, 8), (1, 6)):
        solo = tm.predict_action_tokens(ids[row:row + 1, :n], px[row:row + 1]).numpy()
        np.testing.assert_array_equal(out[row:row + 1], solo)


@pytest.mark.parametrize("name", SPECS)
def test_jacobi_matches_jax_and_ar(name):
    """Jacobi's tokens equal JAX's Jacobi and the AR chain on a ragged batch,
    with the same number of sweeps; a warm start converges to them."""
    jm, params, tm = _pair(name)
    ids, px, am = _ragged(tm)
    ref, ref_iters = jm.predict_action_tokens_jacobi(
        params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(am), return_iters=True)
    out, iters = tm.predict_action_tokens_jacobi(ids, px, am, return_iters=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert iters == int(ref_iters) and 1 <= iters <= 6
    ar = tm.predict_action_tokens_ragged(ids, px, am)
    assert torch.equal(out, ar)
    warm = ar.clone()
    warm[:, 3:] = 5
    jref, jit = jm.predict_action_tokens_jacobi(
        params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(am), return_iters=True,
        init_guess=jnp.asarray(warm.numpy()))
    wout, wit = tm.predict_action_tokens_jacobi(ids, px, am, return_iters=True,
                                                init_guess=warm)
    assert torch.equal(wout, ar) and wit == int(jit)
    np.testing.assert_array_equal(wout.numpy(), np.asarray(jref))


@pytest.mark.parametrize("name", SPECS)
def test_jacobi_logits_at_the_fixed_point_are_ar_steps(name):
    """At the fixed point the last sweep's logits are the AR steps' (fp32,
    within 1e-5 of the largest |logit|), cold and from a guess away from
    the fixed point (two sweeps or more), and for one token."""
    jm, params, tm = _pair(name)
    ids, px, am = _ragged(tm, seed=12)
    inputs = tm._inputs(ids, px, am)
    ar, ar_lg = t_llama.greedy_generate(tm.llama, *inputs, 7, return_logits=True)
    away = (ar + 1) % tm.spec.llama.vocab_size
    for guess in (None, away):
        toks, iters, lg = t_llama.greedy_generate_jacobi(
            tm.llama, *inputs, 7, init_guess=guess, return_iters=True, return_logits=True)
        assert torch.equal(toks, ar) and lg.shape == ar_lg.shape
        assert iters >= (2 if guess is not None else 1)
        scale = ar_lg.abs().max().item()
        assert (lg - ar_lg).abs().max().item() <= 1e-5 * scale
    toks, lg = t_llama.greedy_generate_jacobi(tm.llama, *inputs, 1, return_logits=True)
    assert torch.equal(toks, ar[:, :1])
    assert (lg - ar_lg[:, :1]).abs().max().item() <= 1e-5 * ar_lg.abs().max().item()


def test_jacobi_num_iters_ladder_matches_jax():
    """Exactly k sweeps: the first k + 1 tokens are the AR chain's, and each
    truncated iterate is JAX's."""
    jm, params, tm = _pair("tiny")
    ids, px = _inputs(tm, seed=7)
    ar = tm.predict_action_tokens(ids, px)
    for k in (0, 1, 3, 6):
        ref = jm.predict_action_tokens_jacobi(params, jnp.asarray(ids), jnp.asarray(px),
                                              num_iters=k)
        out, iters = tm.predict_action_tokens_jacobi(ids, px, num_iters=k, return_iters=True)
        assert iters == k
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert torch.equal(out[:, :k + 1], ar[:, :k + 1])
    one, it = t_llama.greedy_generate_jacobi(tm.llama, *tm._inputs(ids, px), 1,
                                             return_iters=True)
    assert it == 0 and torch.equal(one, ar[:, :1])


def test_predict_action_unnormalizes_as_jax():
    jm, params, tm = _pair("tiny")
    ids, px = _inputs(tm, seed=8)
    ids = ids[:, :-1]  # no trailing empty token: predict_action appends it
    for key in (None, "bridge_orig"):
        ref = jm.predict_action(params, ids, px, unnorm_key=key)
        out = tm.predict_action(ids, px, unnorm_key=key)
        assert out.shape == (7,)
        np.testing.assert_array_equal(out, np.asarray(ref))
    assert tm.get_action_dim("bridge_orig") == 7
    toks = tm.predict_action_tokens(np.concatenate([ids, [[j_model.EMPTY_TOKEN]]], 1), px)
    np.testing.assert_array_equal(tm.tokenize_actions(tm.detokenize_actions(toks.numpy())),
                                  jm.tokenize_actions(jm.detokenize_actions(toks.numpy())))


@pytest.mark.parametrize("use_proprio", [False, True])
def test_oft_continuous_actions_match_jax(use_proprio):
    """OFT's parallel forward (bidirectional placeholders, the tail at each
    row's own length) and its head, on a ragged batch, with and without
    the proprio token; predict_action unnormalizes as JAX's."""
    jm, params, tm = _pair("tiny", oft=True, use_proprio=use_proprio)
    ids, px, am = _ragged(tm, seed=9)
    proprio = np.random.RandomState(10).randn(2, 5).astype(np.float32)
    ref = jm.predict_action_continuous(params, jnp.asarray(ids), jnp.asarray(px),
                                       jnp.asarray(proprio), attn_valid=jnp.asarray(am))
    out = tm.predict_action_continuous(ids, px, proprio, attn_valid=am)
    assert out.shape == (2, 2, 7)
    _close(out, ref)
    one = tm.predict_action(ids[:1], px[:1], "bridge_orig", proprio[:1])
    _close(one, jm.predict_action(params, ids[:1], px[:1], "bridge_orig", proprio[:1]))


# ---------------------------------------------------------------------------
# Quantized tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant,force", [("w8a8", ""), ("w4a8", "deq"),
                                         ("w4a8", "interpret")])
@pytest.mark.parametrize("name", SPECS)
def test_quantized_decode_matches_jax(name, quant, force, monkeypatch):
    """JAX's quantized tree carried across (the tied head materialized
    quantized for MiniVLA): the logits of the prompt and the tokens, JAX's
    w4a8 through its dequantizing route and through its Pallas kernel in
    interpret mode."""
    if force:
        monkeypatch.setenv("BLURR_INT4_FORCE", force)
    jm, params, tm = _pair(name, quant=quant)
    kind = t_llama.W8A8Linear if quant == "w8a8" else t_llama.W4A8Linear
    assert isinstance(tm.llama.lm_head, kind)
    assert isinstance(tm.llama.layers[1].down_proj, kind)
    ids, px = _inputs(tm, seed=11)
    spec = jm.spec.llama
    emb = jm._build_prompt_embeds(params, jnp.asarray(ids), jnp.asarray(px))
    cache = j_llama.alloc_cache(spec, 1, emb.shape[1], jnp.float32)
    mask = j_llama.causal_prefill_mask(jnp.ones((1, emb.shape[1]), jnp.int32), emb.shape[1])
    pos = jnp.arange(emb.shape[1])[None]
    h, _ = j_llama.forward(params["llama"], spec, emb, pos, mask, cache, jnp.int32(0))
    ref = j_llama.logits(params["llama"], spec, h)
    temb, valid = tm._inputs(ids, px)
    with torch.no_grad():
        th, _ = tm.llama(temb, torch.from_numpy(np.array(pos)), torch.from_numpy(
            np.array(mask)), t_llama.alloc_cache(tm.llama.spec, 1, temb.shape[1],
                                                   torch.float32, "cpu"), 0)
        _close(th, h)
        _close(tm.llama.logits(th), ref)
    toks = np.asarray(jm.predict_action_tokens(params, jnp.asarray(ids), jnp.asarray(px)))
    np.testing.assert_array_equal(tm.predict_action_tokens(ids, px).numpy(), toks)
    np.testing.assert_array_equal(tm.predict_action_tokens_jacobi(ids, px).numpy(), toks)


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("name", SPECS)
def test_quantizers_match_jax_bytes(name, quant):
    """quantize_llama_* on the same fp weights give JAX's bytes: w8a8 bit for
    bit; w4a8 under the one-ulp ``amax / 7`` rule of the layer weights
    (JAX quantizes them under lax.map), the head (quantized by itself)
    bit for bit."""
    from tests.test_torch_quant import _check_w4a8_layer

    jm, params, tm = _pair(name)
    fp = _np(params["llama"])
    qfn = {"w8a8": j_llama.quantize_llama_w8a8, "w4a8": j_llama.quantize_llama_w4a8}[quant]
    tree = _np(qfn(params["llama"]))
    {"w8a8": t_llama.quantize_llama_w8a8, "w4a8": t_llama.quantize_llama_w4a8}[quant](tm.llama)
    attrs = {"q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
             "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj"}
    for i, layer in enumerate(tm.llama.layers):
        for key, attr in attrs.items():
            mod, leaf = getattr(layer, attr), tree["layers"][key]
            if quant == "w8a8":
                np.testing.assert_array_equal(mod.q8a.numpy(), leaf["q8a"][i])
                np.testing.assert_array_equal(mod.s.numpy(), leaf["s"][i])
            else:
                _check_w4a8_layer(fp["layers"][key][i],
                                  {"q4": leaf["q4"][i], "s": leaf["s"][i]}, mod)
    head = tm.llama.lm_head
    for key in ("q8a", "s") if quant == "w8a8" else ("q4", "s"):
        np.testing.assert_array_equal(getattr(head, key).numpy(), tree["lm_head"][key])
    assert tm.llama.embed_tokens.dtype == torch.float32  # the gather stays fp


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("name", SPECS)
def test_quantized_init_has_jax_layout(name, quant):
    """Llama(quant_init=...) holds every leaf JAX's init_llama_params_w8a8 /
    _w4a8 holds, at its shape and dtype (the head too where tied; the Qwen2
    biases), and draws int8 bytes and JAX's constant scales."""
    spec = getattr(j_model.OpenVLASpec, name)().llama
    tspec = getattr(t_model.OpenVLASpec, name)().llama
    init = {"w8a8": j_llama.init_llama_params_w8a8, "w4a8": j_llama.init_llama_params_w4a8}
    tree = _np(init[quant](jax.random.PRNGKey(0), spec, jnp.float32))
    llama = t_llama.Llama(tspec, device="cpu", dtype=torch.float32, quant_init=quant)
    llama.init_params(torch.Generator().manual_seed(0))
    # copies only where every kind and shape agrees, and sets every tensor
    copy_pairs(llama, llama_pairs(llama, tree))
    fresh = t_llama.Llama(tspec, device="cpu", dtype=torch.float32, quant_init=quant)
    fresh.init_params(torch.Generator().manual_seed(1))
    key = "q8a" if quant == "w8a8" else "q4"
    q = getattr(fresh.layers[0].gate_proj, key)
    assert q.dtype == torch.int8 and int(q.min()) < -100 and int(q.max()) > 100
    s = fresh.layers[0].down_proj.s
    expected = spec.intermediate_size**-0.5 / (127.0 if quant == "w8a8" else 7.0)
    assert torch.allclose(s, torch.full_like(s, expected))


def test_llama_rejects_an_unknown_quant_init():
    with pytest.raises(ValueError, match="quant_init"):
        t_llama.Llama(t_model.OpenVLASpec.tiny().llama, device="cpu", dtype=torch.float32,
                      quant_init="int8")


def test_specs_and_random_ids_match_jax():
    for name in ("tiny", "minivla", "tiny_minivla"):
        j, t = getattr(j_model.OpenVLASpec, name)(), getattr(t_model.OpenVLASpec, name)()
        assert repr(j).replace("blurr_tpu.", "") == repr(t).replace("blurr_tpu_torch.", "")
    assert repr(j_model.OpenVLASpec()) == repr(t_model.OpenVLASpec())
    assert sorted(j_model.RANDOM_SPECS) == sorted(t_model.RANDOM_SPECS)
    for key in j_model.RANDOM_SPECS:
        assert repr(j_model.RANDOM_SPECS[key]()) == repr(t_model.RANDOM_SPECS[key]())
