"""Pi-0's text mode in the port (``joint.single_forward``,
``infer_text_prefill`` / ``infer_text_decode_step``,
``load_pretrained_weights``) against the JAX package, on the CPU.

Set-up as ``tests/test_torch_pizero.py``: JAX init_params ->
tie_action_proprio_weights -> numpy -> load_jax_params; inputs from numpy
seeds. Tolerances, fp32: hidden states and caches atol 1e-5, logits
atol 1e-5 plus 1e-5 relative (the same fp32 formulas summed in another
order through 3 layers and the 2-layer SigLIP); tokens equal. The prefill of a 70-token prompt takes the flash route
(``use_flash_attn``, >= 64 query rows), whose CPU version is the plain
attention: the test counts its calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0 import joint as j_joint
from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import (
    load_jax_params,
    paligemma_state_dict,
    save_safetensors,
)
from blurr_tpu_torch.models.pi0.pizero import PiZero
from tests.util import tiny_pi0_cfg

TOL = 1e-5
LOGITS_RTOL = 1e-5
Q_LEN = 70  # >= joint.FLASH_MIN_QUERIES: the prefill takes the flash route


def _pair(flash: bool = False, final_norm: bool = False, seed: int = 0):
    """(JAX model, JAX params, port model) on the same fp32 weights."""
    cfg = tiny_pi0_cfg()
    cfg.joint.config.head_dim = 32  # a head_dim the flash route takes
    cfg.joint.config.use_flash_attn = flash
    cfg.mixture.vlm.use_final_norm = final_norm
    cfg.joint.config.mixture = cfg.mixture
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(seed)))
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompts(cfg_spec, batch=2, q_len=Q_LEN, seed=0):
    """Image tokens first, then random text; numpy ids and pixels."""
    rng = np.random.RandomState(seed)
    n_img = 4
    text = rng.randint(3, cfg_spec.vocab_size - 1, (batch, q_len - n_img))
    text[text == cfg_spec.image_token_index] = 3
    ids = np.concatenate([np.full((batch, n_img), cfg_spec.image_token_index), text], 1)
    px = (rng.rand(batch, 3, 28, 28) * 2 - 1).astype(np.float32)
    return ids.astype(np.int32), px


@pytest.mark.parametrize("softclamp", [True, False])
@pytest.mark.parametrize("case", ["no_cache", "cache", "cache_at_offset"])
def test_single_forward(case, softclamp):
    """The vlm mixture alone: hidden states and (in place) the cache."""
    jm, params, tm = _pair(final_norm=True)
    j_spec = dataclasses.replace(jm.joint_spec, use_softclamp=softclamp)
    t_spec = dataclasses.replace(tm.joint_spec, use_softclamp=softclamp)
    rng = np.random.RandomState(1)
    b, s, h, max_len = 2, 5, 32, 12
    embeds = rng.randn(b, s, h).astype(np.float32)
    offset = 3 if case == "cache_at_offset" else 0
    pos = np.broadcast_to(np.arange(offset + 1, offset + s + 1), (b, s)).astype(np.int32)
    skv = s if case == "no_cache" else max_len
    mask = rng.rand(b, s, skv) > 0.3
    mask[:, :, offset] = True
    cache = None
    if case != "no_cache":
        sp = tm.joint_spec
        shape = (sp.num_hidden_layers, b, sp.num_key_value_heads, max_len, sp.head_dim)
        cache = tuple(rng.randn(*shape).astype(np.float32) for _ in range(2))
    j_h, j_cache = j_joint.single_forward(
        params["joint"], j_spec, "vlm", jnp.asarray(embeds), jnp.asarray(pos),
        jnp.asarray(mask), None if cache is None else tuple(map(jnp.asarray, cache)),
        jnp.int32(offset),
    )
    t_cache = None if cache is None else tuple(torch.from_numpy(c.copy()) for c in cache)
    with torch.no_grad():
        t_h, t_out = t_joint.single_forward(
            tm.joint["vlm"], t_spec, "vlm", torch.from_numpy(embeds),
            torch.from_numpy(pos).long(), torch.from_numpy(mask), t_cache, offset,
        )
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), atol=TOL, rtol=0)
    if cache is None:
        assert t_out is None and j_cache is None
    else:
        assert t_out is t_cache  # written in place
        for t, j in zip(t_out, j_cache):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


def test_single_forward_rejects_an_overflowing_cache():
    _, _, tm = _pair()
    sp = tm.joint_spec
    cache = t_joint.alloc_single_cache(sp, 1, 6, torch.float32, "cpu")
    assert cache[0].shape == (sp.num_hidden_layers, 1, sp.num_key_value_heads, 6, sp.head_dim)
    with pytest.raises(ValueError, match="overflow"), torch.no_grad():
        t_joint.single_forward(
            tm.joint["vlm"], tm.joint_spec, "vlm", torch.zeros(1, 4, 32),
            torch.ones(1, 4, dtype=torch.long), torch.ones(1, 4, 6, dtype=torch.bool),
            cache, 3,
        )


def _count_flash(monkeypatch):
    calls = []
    real = t_joint.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(t_joint, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_text_prefill_and_decode(flash, padded, monkeypatch):
    """Prefill logits, each greedy token, and the cache after 4 decode
    steps; the padded case right-pads row 1 (attention_mask / attn_valid)
    and gives the vlm a final norm."""
    jm, params, tm = _pair(flash, final_norm=padded)
    ids, px = _prompts(jm.spec)
    am = None
    if padded:
        am = np.ones_like(ids)
        am[1, -3:] = 0
        ids[1, -3:] = 0
    max_len = Q_LEN + 5
    calls = _count_flash(monkeypatch)
    j_am = None if am is None else jnp.asarray(am)
    t_am = None if am is None else torch.from_numpy(am)
    j_logits, j_cache, j_len = jm.infer_text_prefill(
        params, jnp.asarray(ids), jnp.asarray(px), max_len, attention_mask=j_am)
    t_logits, t_cache, t_len = tm.infer_text_prefill(
        torch.from_numpy(ids).long(), torch.from_numpy(px), max_len, attention_mask=t_am)
    assert t_len == int(j_len) == Q_LEN
    assert len(calls) == (tm.joint_spec.num_hidden_layers if flash else 0)  # one a layer
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL,
                               rtol=LOGITS_RTOL)
    j_tok = jnp.argmax(j_logits[:, -1], axis=-1)
    t_tok = t_logits[:, -1].argmax(-1)
    for _ in range(4):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        j_tok, j_cache, j_len = jm.infer_text_decode_step(
            params, j_tok, j_cache, j_len, attn_valid=j_am)
        t_tok, t_cache, t_len = tm.infer_text_decode_step(t_tok, t_cache, t_len, attn_valid=t_am)
        assert t_len == int(j_len)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    # a decode step's one query row takes the plain attention
    assert len(calls) == (tm.joint_spec.num_hidden_layers if flash else 0)
    for t, j in zip(t_cache, j_cache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_text_padding_is_invisible(flash):
    """As tests/test_pizero.py's test of JAX: a right-padded row generates
    the tokens it generates alone, unpadded (fp32)."""
    _, _, tm = _pair(flash, final_norm=True, seed=3)
    ids, px = _prompts(tm.spec, seed=3)
    n_valid = Q_LEN - 3
    ids[1, n_valid:] = 0
    am = np.ones_like(ids)
    am[1, n_valid:] = 0

    def gen(ids_b, px_b, am_b, steps=4):
        am_t = torch.from_numpy(am_b)
        logits, cache, cache_len = tm.infer_text_prefill(
            torch.from_numpy(ids_b).long(), torch.from_numpy(px_b),
            ids_b.shape[1] + steps + 1, attention_mask=am_t)
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for _ in range(steps - 1):
            tok, cache, cache_len = tm.infer_text_decode_step(tok, cache, cache_len, am_t)
            toks.append(tok)
        return torch.stack(toks, 1).numpy()

    batch = gen(ids, px, am)
    solo = gen(ids[1:2, :n_valid], px[1:2], np.ones((1, n_valid), np.int32))
    np.testing.assert_array_equal(batch[1], solo[0])


def _hf_shards(path, tm: PiZero, final_norm: bool, seed: int = 5):
    """An HF PaliGemma snapshot of random tensors at the tiny Pi-0's
    widths, in two shards: the first written by the ``safetensors``
    package, the second by the port's writer."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(seed)
    state = paligemma_state_dict(tm.embed_tokens, tm.vision_tower,
                                 tm.multi_modal_projector, tm.joint["vlm"])
    state = {k: torch.randn(v.shape, generator=g) * 0.2 for k, v in state.items()}
    if final_norm:
        state["language_model.model.norm.weight"] = torch.randn(32, generator=g)
    keys = sorted(state)
    half = len(keys) // 2
    save_file({k: state[k] for k in keys[:half]}, str(path / "model-00001-of-00002.safetensors"))
    save_safetensors({k: state[k] for k in keys[half:]},
                     str(path / "model-00002-of-00002.safetensors"))


@pytest.mark.parametrize("final_norm", [False, True])
def test_load_pretrained_weights(tmp_path, final_norm):
    """Pi-0's vlm, SigLIP, projector and embedding from a 2-shard
    safetensors directory: the port's weights equal JAX's
    load_pretrained_weights on the same files, and so do the text logits.
    A final norm in the files loads only where the vlm has one."""
    jm, params, tm = _pair(final_norm=final_norm)
    _hf_shards(tmp_path, tm, final_norm=True)
    j_params = jm.load_pretrained_weights(params, str(tmp_path))
    want = PiZero(tm.cfg, device="cpu", dtype=torch.float32)
    load_jax_params(want, jax.tree.map(np.asarray, j_params))
    assert tm.load_pretrained_weights(str(tmp_path)) is tm
    got, ref = dict(tm.named_parameters()), dict(want.named_parameters())
    assert got.keys() == ref.keys()
    for name in got:
        assert torch.equal(got[name], ref[name]), name
    ids, px = _prompts(jm.spec, q_len=9)
    j_logits, _, _ = jm.infer_text_prefill(j_params, jnp.asarray(ids), jnp.asarray(px), 12)
    t_logits, _, _ = tm.infer_text_prefill(torch.from_numpy(ids).long(),
                                           torch.from_numpy(px), 12)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL,
                               rtol=LOGITS_RTOL)
