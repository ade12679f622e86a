"""The port's standalone PaliGemma and Gemma (``blurr_tpu_torch/models/
paligemma``), its safetensors reader and writer, and the text demo CLI,
against the JAX package on the CPU.

Weights: JAX ``init_params`` carried across by ``load_jax_params``; inputs
from numpy seeds. Tolerances, fp32: logits atol 1e-5 plus 1e-5 relative
(the same fp32 formulas summed in another order through 2 layers and the
2-layer SigLIP); tokens and loaded weights equal. The clamp-off case scales
the vlm's q and k weights until attention logits pass 50, where a clamp at
50 moves the output far beyond that tolerance.
"""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.paligemma import config as j_config
from blurr_tpu.models.paligemma import model as j_model
from blurr_tpu.models.paligemma.load import load_hf_model as j_load_hf_model
from blurr_tpu.models.paligemma.processing import PaliGemmaProcessor as JProcessor
from blurr_tpu.models.pi0.processing import StubTokenizer as JStub
from blurr_tpu_torch.models.paligemma import config as t_config
from blurr_tpu_torch.models.paligemma import model as t_model
from blurr_tpu_torch.models.paligemma.load import load_hf_model, load_jax_params
from blurr_tpu_torch.models.paligemma.processing import PaliGemmaProcessor
from blurr_tpu_torch.models.pi0 import checkpoint
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.processing import StubTokenizer

REPO_ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOGITS_RTOL = 1e-5
TEXT = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, head_dim=16)
CONFIG = dict(
    vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 2, "image_size": 28, "patch_size": 14},
    text_config=TEXT, image_token_index=260, pad_token_id=0, projection_dim=32,
    hidden_size=32,
)


def _pair(seed=0, scale_qk=1.0):
    """(JAX model, JAX params, port model) on the same fp32 weights; the vlm's
    q and k weights times ``scale_qk`` on both sides."""
    jm = j_model.PaliGemmaForConditionalGeneration(j_config.PaliGemmaConfig(**CONFIG))
    params = jm.init_params(jax.random.PRNGKey(seed))
    vlm = params["joint"]["vlm"]
    vlm["q_w"], vlm["k_w"] = vlm["q_w"] * scale_qk, vlm["k_w"] * scale_qk
    tm = t_model.PaliGemmaForConditionalGeneration(
        t_config.PaliGemmaConfig(**CONFIG), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _inputs(batch=2, n_text=5, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([np.full((batch, 4), 260), rng.randint(3, 259, (batch, n_text))], 1)
    return ids.astype(np.int32), rng.rand(batch, 3, 28, 28).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=LOGITS_RTOL)


@pytest.mark.parametrize("raw", [
    CONFIG,
    {},  # google/paligemma-3b-pt-224's widths
    {**CONFIG, "pad_token_id": None, "text_config": {**TEXT, "pad_token_id": 7}},
    {**CONFIG, "text_config": {**TEXT, "pad_token_id": 7}, "model_type": "paligemma"},
])
def test_config_matches_jax(raw):
    """The port's own copy of the config classes: every field, the
    pad_token_id precedence and the derived num_image_tokens."""
    j, t = j_config.PaliGemmaConfig(**raw), t_config.PaliGemmaConfig(**raw)
    flat = lambda c: {k: (v.to_dict() if hasattr(v, "to_dict") else v)
                      for k, v in vars(c).items()}
    assert flat(t) == flat(j)


def test_prefill_and_decode_without_the_clamp(monkeypatch):
    """Attention logits past 50: the port's PaliGemma matches JAX's (no
    soft clamp, plain attention), and the same model with the clamp on
    would not."""
    jm, params, tm = _pair(scale_qk=12.0)
    seen = []
    real = t_joint.grouped_attention

    def recording(q, k, v, mask=None, softclamp=50.0, scale=None):
        logits = torch.einsum("bhqd,bksd->bhqs", q.float(),
                              k.float().repeat_interleave(q.shape[1] // k.shape[1], 1))
        seen.append((softclamp, (logits * q.shape[-1] ** -0.5).abs().max().item()))
        return real(q, k, v, mask, softclamp, scale)

    monkeypatch.setattr(t_joint, "grouped_attention", recording)
    ids, px = _inputs()
    j_logits, j_cache, j_len = jm.prefill(params, jnp.asarray(ids), jnp.asarray(px), 12)
    t_ids, t_px = torch.from_numpy(ids).long(), torch.from_numpy(px)
    t_logits, t_cache, t_len = tm.prefill(t_ids, t_px, 12)
    assert t_len == int(j_len) == ids.shape[1]
    assert all(clamp is None for clamp, _ in seen) and max(m for _, m in seen) > 50
    _close(t_logits, j_logits)
    tok = jnp.argmax(j_logits[:, -1], axis=-1)
    j_next, _, _ = jm.decode_step(params, tok, j_cache, j_len)
    t_next, _, _ = tm.decode_step(torch.from_numpy(np.array(tok)), t_cache, t_len)
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    tm.joint_spec = dataclasses.replace(tm.joint_spec, use_softclamp=True)
    clamped, _, _ = tm.prefill(t_ids, t_px, 12)
    assert (clamped - t_logits).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("eos", [None, "row 0's first token"])
def test_generate_and_generate_fused_match_jax(eos):
    """Greedy tokens of generate and generate_fused equal JAX's; with an
    EOS that row 0 emits first, row 0 repeats it and host generate stops
    once every row has (tests/test_paligemma.py's per-row EOS)."""
    jm, params, tm = _pair(seed=5)
    ids, px = _inputs(seed=6)
    eos_id = None if eos is None else int(tm.generate(ids, px, max_new_tokens=1)[0, 0])
    j_host = jm.generate(params, ids, px, max_new_tokens=6, eos_token_id=eos_id)
    j_fused = jm.generate_fused(params, ids, px, max_new_tokens=6, eos_token_id=eos_id)
    t_host = tm.generate(ids, px, max_new_tokens=6, eos_token_id=eos_id)
    t_fused = tm.generate_fused(ids, px, max_new_tokens=6, eos_token_id=eos_id)
    np.testing.assert_array_equal(t_host, j_host)
    np.testing.assert_array_equal(t_fused, j_fused)
    np.testing.assert_array_equal(t_fused[:, :t_host.shape[1]], t_host)
    if eos is not None:
        assert (t_fused[0] == eos_id).all()
    # fused_tokens' last logits: those of decode_logits teacher-forced on
    # its tokens, the same bits (the same operations on the CPU)
    tokens, last = tm.fused_tokens(ids, px, max_new_tokens=6, eos_token_id=eos_id)
    np.testing.assert_array_equal(tokens.numpy(), t_fused)
    logits, cache, n = tm.prefill(torch.from_numpy(ids).long(), torch.from_numpy(px), 15)
    for tok in tokens[:, :-1].T:
        logits, cache, n = tm.decode_logits(tok, cache, n)
    assert n == 14 and torch.equal(last, logits[:, -1])


def test_gemma_causal_lm_matches_jax():
    """Text-only Gemma: no vision tower, the prefill logits and the greedy
    tokens of JAX's; decoding with the cache equals prefilling the growing
    prompt (tests/test_paligemma.py's check)."""
    cfg = j_config.GemmaConfig(**TEXT, pad_token_id=0)
    jm = j_model.GemmaForCausalLM(cfg)
    params = jm.init_params(jax.random.PRNGKey(1))
    tm = t_model.GemmaForCausalLM(t_config.GemmaConfig(**TEXT, pad_token_id=0), device="cpu")
    assert not hasattr(tm, "vision_tower")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    ids = np.random.RandomState(2).randint(3, 299, (2, 6)).astype(np.int32)
    j_logits, _, _ = jm.prefill(params, jnp.asarray(ids), 6)
    t_logits, _, _ = tm.prefill(torch.from_numpy(ids).long(), 6)
    _close(t_logits, j_logits)
    toks = tm.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(toks, jm.generate(params, ids, max_new_tokens=4))
    cur = ids[:1]
    for want in toks[0]:
        logits, _, _ = tm.prefill(torch.from_numpy(cur).long(), cur.shape[1])
        assert int(logits[0, -1].argmax()) == want
        cur = np.concatenate([cur, [[want]]], axis=1)


def test_processor_matches_jax():
    """PIL bicubic resize, rescale, normalize and the prompt's ids equal
    JAX's processor's (the stub tokenizers hash words alike in one
    process)."""
    from PIL import Image

    image = Image.fromarray(np.random.RandomState(0).randint(0, 256, (40, 52, 3), np.uint8))
    j = JProcessor(JStub(vocab_size=300, image_token_id=260), 4, 28)(
        ["what is on the table"], [image])
    t = PaliGemmaProcessor(StubTokenizer(vocab_size=300, image_token_id=260), 4, 28)(
        ["what is on the table"], [image])
    assert t.keys() == j.keys()
    for key in t:
        assert t[key].dtype == j[key].dtype
        np.testing.assert_array_equal(t[key], j[key])
    assert t["pixel_values"].shape == (1, 3, 28, 28)


def _write_snapshot(path: Path, tm, dtype=torch.float32):
    """config.json and the port model's weights as two HF shards."""
    (path / "config.json").write_text(json.dumps(CONFIG))
    state = checkpoint.paligemma_state_dict(tm.embed_tokens, tm.vision_tower,
                                            tm.multi_modal_projector, tm.vlm)
    state = {k: v.to(dtype) for k, v in state.items()}
    keys = sorted(state)
    for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
        checkpoint.save_safetensors({k: state[k] for k in part},
                                    str(path / f"model-0000{i + 1}-of-00002.safetensors"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_hf_model_matches_jax(tmp_path, dtype):
    """load_hf_model on a 2-shard directory the test writes: the weights
    equal JAX's load_hf_model's (paligemma_params_from_safetensors, the
    same files), so do the tokens, and the prefill logits in fp32."""
    _, _, src = _pair(seed=7)
    _write_snapshot(tmp_path, src, dtype)
    j_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm, j_params = j_load_hf_model(str(tmp_path), j_dtype)
    tm = load_hf_model(str(tmp_path), dtype, device="cpu")
    assert isinstance(tm, t_model.PaliGemmaForConditionalGeneration)
    want = t_model.PaliGemmaForConditionalGeneration(tm.config, device="cpu", dtype=dtype)
    load_jax_params(want, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), j_params))
    for (name, p), q in zip(tm.named_parameters(), want.parameters()):
        assert p.dtype == dtype and torch.equal(p, q), name
    ids, px = _inputs(seed=8)
    if dtype == torch.float32:
        j_logits, _, _ = jm.prefill(j_params, jnp.asarray(ids), jnp.asarray(px), 12)
        t_logits, _, _ = tm.prefill(torch.from_numpy(ids).long(), torch.from_numpy(px), 12)
        _close(t_logits, j_logits)
        np.testing.assert_array_equal(tm.generate(ids, px, max_new_tokens=4),
                                      jm.generate(j_params, ids, px, max_new_tokens=4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    """The port's reader reads what the ``safetensors`` package writes, and
    the package reads what the port's writer writes, bit for bit."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(5, 7, generator=g).to(dtype),
               "b": torch.randn(3, 2, 4, generator=g).to(dtype),
               "scalar": torch.tensor(1.5, dtype=dtype),
               "wide": torch.randn(9, generator=g)}
    save_file(tensors, str(tmp_path / "package.safetensors"))
    checkpoint.save_safetensors(tensors, str(tmp_path / "port.safetensors"))
    for got in (checkpoint.read_safetensors(str(tmp_path / "package.safetensors")),
                load_file(str(tmp_path / "port.safetensors"))):
        assert got.keys() == tensors.keys()
        for key, t in tensors.items():
            assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    both = checkpoint.load_safetensors_dir(str(tmp_path))
    assert both.keys() == tensors.keys()


def test_safetensors_reader_refuses_what_it_cannot_read(tmp_path):
    from safetensors.torch import save_file

    save_file({"ids": torch.arange(4)}, str(tmp_path / "ints.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        checkpoint.read_safetensors(str(tmp_path / "ints.safetensors"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .safetensors file"):
        checkpoint.load_safetensors_dir(str(tmp_path / "empty"))


def _demo():
    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    try:
        import demo_paligemma_text_torch
    finally:
        sys.path.pop(0)
    return demo_paligemma_text_torch


@pytest.mark.parametrize("fused", [False, True])
def test_demo_random_mode_on_the_cpu(fused, capsys):
    args = ["--device", "cpu", "--max-new-tokens", "4"] + (["--fused"] if fused else [])
    assert _demo().main(args) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("Generated token ids:"))
    toks = json.loads(line.split(":", 1)[1])
    assert len(toks) == 4 and all(0 <= t < 300 for t in toks)


def _jax_demo_flags():
    """{flag: default} of every add_argument in the JAX demo's source."""
    tree = ast.parse((REPO_ROOT / "scripts" / "demo_paligemma_text.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else (
                False if "action" in kw else None)
            flags[ast.literal_eval(node.args[0])] = default
    return flags


def test_demo_flags_are_the_jax_demos_and_device():
    parser = _demo().build_parser()
    ours = {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert ours == {**_jax_demo_flags(), "--device": "cuda"}
