"""The port's OpenVLA weights in (``models/openvla/checkpoint.py``) and its
model-id resolution (``models/openvla/build.py``) against the JAX package,
on files each test writes in ``tmp_path``: a fused HF snapshot (written by
the port's safetensors writer, read by both), a Qwen2-style LLM, a
prismatic vision ``.pt`` state, OFT aux checkpoints both ways, the norm
statistics from ``dataset_statistics.json`` and from the ``config.json``
fallback, ``infer_unnorm_key``, and ``build_openvla``'s ids and errors.
fp32; trees equal leaf for leaf, actions equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.openvla import build as j_build
from blurr_tpu.models.openvla import checkpoint as j_ckpt
from blurr_tpu.models.openvla import model as j_model
from blurr_tpu_torch.models.openvla import build as t_build
from blurr_tpu_torch.models.openvla import checkpoint as t_ckpt
from blurr_tpu_torch.models.openvla import model as t_model
from blurr_tpu_torch.models.openvla.llama import quantize_llama_w8a8
from blurr_tpu_torch.models.pi0.checkpoint import save_safetensors

STATS = {"bridge_orig": {"action": {"q01": [-1.0] * 7, "q99": [0.5] * 7,
                                    "mask": [True] * 6 + [False]}},
         "fractal": {"action": {"q01": [0.0] * 7, "q99": [1.0] * 7}}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        t = tree.float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        yield prefix[:-1], t


def _same_tree(ours, theirs):
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _llama_state(spec, prefix, rng, qwen=False):
    t = lambda *shape: torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32))
    hd = spec.head_dim
    state = {prefix + "model.embed_tokens.weight": t(spec.vocab_size, spec.hidden_size),
             prefix + "model.norm.weight": t(spec.hidden_size)}
    if not qwen:
        state[prefix + "lm_head.weight"] = t(spec.vocab_size, spec.hidden_size)
    for i in range(spec.num_layers):
        lp = f"{prefix}model.layers.{i}."
        for name, out, inn in (("self_attn.q_proj", spec.num_heads * hd, spec.hidden_size),
                               ("self_attn.k_proj", spec.num_kv_heads * hd, spec.hidden_size),
                               ("self_attn.v_proj", spec.num_kv_heads * hd, spec.hidden_size),
                               ("self_attn.o_proj", spec.hidden_size, spec.num_heads * hd),
                               ("mlp.gate_proj", spec.intermediate_size, spec.hidden_size),
                               ("mlp.up_proj", spec.intermediate_size, spec.hidden_size),
                               ("mlp.down_proj", spec.hidden_size, spec.intermediate_size)):
            state[lp + name + ".weight"] = t(out, inn)
            if qwen and name[-6:] in ("q_proj", "k_proj", "v_proj"):
                state[lp + name + ".bias"] = t(out)
        state[lp + "input_layernorm.weight"] = t(spec.hidden_size)
        state[lp + "post_attention_layernorm.weight"] = t(spec.hidden_size)
    return state


def _vit_state(prefix, vs, rng, cls_reg):
    t = lambda *shape: torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32))
    d, inter = vs.hidden_size, vs.intermediate_size
    state = {prefix + "patch_embed.proj.weight": t(d, 3, vs.patch_size, vs.patch_size),
             prefix + "patch_embed.proj.bias": t(d),
             # timm reg4 models store a patches-only table
             prefix + "pos_embed": t(1, vs.num_patches, d)}
    if cls_reg:
        state[prefix + "cls_token"] = t(1, 1, d)
        state[prefix + "reg_token"] = t(1, vs.reg_tokens, d)
    for i in range(vs.num_layers + 1):  # one block past the ones that run
        bp = prefix + f"blocks.{i}."
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
                            ("mlp.fc1.weight", (inter, d)), ("mlp.fc1.bias", (inter,)),
                            ("mlp.fc2.weight", (d, inter)), ("mlp.fc2.bias", (d,))):
            state[bp + name] = t(*shape)
        if cls_reg:
            state[bp + "ls1.gamma"] = t(d)
            state[bp + "ls2.gamma"] = t(d)
    return state


def write_snapshot(path, spec, seed=0, sidecar=True):
    """A fused OpenVLA snapshot of ``spec`` under HF keys, written by the
    port's safetensors writer in two shards, with dataset_statistics.json
    (and blurr_spec.json)."""
    rng = np.random.RandomState(seed)
    state = _llama_state(spec.llama, "language_model.", rng)
    state.update(_vit_state("vision_backbone.featurizer.", spec.dinov2, rng, True))
    state.update(_vit_state("vision_backbone.fused_featurizer.", spec.siglip, rng, False))
    for name, din in (("fc1", spec.vision_dim), ("fc2", spec.llama.hidden_size),
                      ("fc3", spec.llama.hidden_size)):
        state[f"projector.{name}.weight"] = torch.from_numpy(
            (rng.randn(spec.llama.hidden_size, din) * 0.05).astype(np.float32))
        state[f"projector.{name}.bias"] = torch.zeros(spec.llama.hidden_size)
    keys = sorted(state)
    half = len(keys) // 2
    save_safetensors({k: state[k] for k in keys[:half]}, str(path / "model-1.safetensors"))
    save_safetensors({k: state[k] for k in keys[half:]}, str(path / "model-2.safetensors"))
    (path / "dataset_statistics.json").write_text(json.dumps(STATS))
    if sidecar:
        import dataclasses

        (path / "blurr_spec.json").write_text(json.dumps(dataclasses.asdict(spec)))
    return state


def test_fused_snapshot_tree_matches_jax(tmp_path):
    spec = t_model.OpenVLASpec.tiny()
    write_snapshot(tmp_path, spec)
    jspec = j_model.OpenVLASpec.from_snapshot_dir(tmp_path)
    assert repr(t_model.OpenVLASpec.from_snapshot_dir(tmp_path)) == repr(jspec) == repr(spec)
    ours = t_ckpt.openvla_params_from_hf_dir(str(tmp_path), spec)
    theirs = j_ckpt.openvla_params_from_hf_dir(str(tmp_path), jspec, jnp.float32)
    _same_tree(ours, theirs)
    assert ours["dinov2"]["pos_embed"].shape[0] == spec.dinov2.num_patches


def test_build_from_snapshot_serves_jax_actions(tmp_path):
    """build_openvla on the directory (spec from blurr_spec.json, stats from
    dataset_statistics.json): the same actions as JAX's build, unnormalized."""
    spec = t_model.OpenVLASpec.tiny()
    write_snapshot(tmp_path, spec, seed=1)
    built = t_build.build_openvla(str(tmp_path), device="cpu", dtype=torch.float32)
    jb = j_build.build_openvla(str(tmp_path), dtype=jnp.float32)
    assert built.norm_stats == jb.norm_stats == STATS
    assert built.dataset_stats == jb.dataset_stats
    assert built.model.dinov2.pos_embed.shape[0] == spec.dinov2.num_patches
    rng = np.random.RandomState(2)
    ids = np.array([[1, 500, 900, 1200, j_model.EMPTY_TOKEN]], np.int32)
    px = rng.rand(1, 6, 28, 28).astype(np.float32)
    out = built.model.predict_action(ids, px, unnorm_key="bridge_orig")
    ref = jb.model.predict_action(jb.params, ids, px, unnorm_key="bridge_orig")
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_snapshot_with_lora_adapter_is_refused(tmp_path):
    """A snapshot's lora_adapter/ directory is merged into the LLM as both
    packages load it (it was refused before the PEFT half was ported): the
    same merged tree, and the unmerged one with merge_lora False."""
    from blurr_tpu.ops.lora import save_peft_adapter

    spec = t_model.OpenVLASpec.tiny()
    write_snapshot(tmp_path, spec)
    rng = np.random.RandomState(3)
    n, h = spec.llama.num_layers, spec.llama.hidden_size
    q_out = spec.llama.num_heads * spec.llama.head_dim
    save_peft_adapter({"q_w": {"lora_a": rng.randn(n, h, 2).astype(np.float32),
                               "lora_b": rng.randn(n, 2, q_out).astype(np.float32) * 0.1,
                               "lora_s": np.full((n,), 2.0, np.float32)}},
                      str(tmp_path / "lora_adapter"))
    ours = t_ckpt.openvla_params_from_hf_dir(str(tmp_path), spec)
    theirs = j_ckpt.openvla_params_from_hf_dir(str(tmp_path), j_model.OpenVLASpec.tiny(),
                                               jnp.float32)
    plain = t_ckpt.openvla_params_from_hf_dir(str(tmp_path), spec, merge_lora=False)
    q, q0 = ours["llama"]["layers"]["q_w"], plain["llama"]["layers"]["q_w"]
    assert (q - q0).abs().max() > 1e-3
    # JAX merges into bf16 whatever the dtype it loads in; the port into
    # the tree's own dtype (fp32 here)
    np.testing.assert_allclose(np.asarray(theirs["llama"]["layers"]["q_w"], np.float32),
                               q.numpy(), rtol=0, atol=4e-3 * float(q.abs().max()))
    _same_tree({k: v for k, v in ours["llama"]["layers"].items() if k != "q_w"},
               {k: v for k, v in theirs["llama"]["layers"].items() if k != "q_w"})


def test_qwen2_style_llm_tree_matches_jax():
    """Qwen2 (MiniVLA's LLM): q/k/v biases bridged, no lm_head; a partial
    bias set is ignored, as JAX ignores it."""
    spec = t_model.OpenVLASpec.tiny_minivla().llama
    state = _llama_state(spec, "llm_backbone.llm.", np.random.RandomState(3), qwen=True)
    ours = t_ckpt.llama_params_from_hf(state, prefix="llm_backbone.llm.")
    _same_tree(ours, j_ckpt.llama_params_from_hf(state, prefix="llm_backbone.llm."))
    assert "lm_head" not in ours and {"q_b", "k_b", "v_b"} <= set(ours["layers"])
    del state["llm_backbone.llm.model.layers.1.self_attn.v_proj.bias"]
    ours = t_ckpt.llama_params_from_hf(state, prefix="llm_backbone.llm.")
    _same_tree(ours, j_ckpt.llama_params_from_hf(state, prefix="llm_backbone.llm."))
    assert "q_b" not in ours["layers"]


def test_prismatic_vision_tree_matches_jax():
    spec = t_model.OpenVLASpec.tiny_minivla()
    rng = np.random.RandomState(4)
    state = _vit_state("vision_backbone.featurizer.", spec.siglip, rng, False)
    for i, (o, n) in enumerate(((64, 48), (64, 64))):
        state[f"projector.projector.{2 * i}.weight"] = torch.from_numpy(
            rng.randn(o, n).astype(np.float32))
        state[f"projector.projector.{2 * i}.bias"] = torch.zeros(o)
    jspec = j_model.OpenVLASpec.tiny_minivla()
    for ours, theirs in zip(t_ckpt.prismatic_vision_params(state, spec),
                            j_ckpt.prismatic_vision_params(state, jspec)):
        _same_tree(ours, theirs)
    del state["projector.projector.0.weight"]
    with pytest.raises(KeyError):
        t_ckpt.prismatic_vision_params(state, spec)


def _oft_tree(rng, in_dim=12, hidden=8, out=6, n_blocks=2):
    r = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    head = {"ln1_w": r(in_dim), "ln1_b": r(in_dim), "fc1_w": r(in_dim, hidden),
            "fc1_b": r(hidden),
            "blocks": {"ln_w": r(n_blocks, hidden), "ln_b": r(n_blocks, hidden),
                       "w": r(n_blocks, hidden, hidden), "b": r(n_blocks, hidden)},
            "ln2_w": r(hidden), "ln2_b": r(hidden), "fc2_w": r(hidden, out), "fc2_b": r(out)}
    proj = {"fc1_w": r(5, hidden), "fc1_b": r(hidden), "fc2_w": r(hidden, hidden),
            "fc2_b": r(hidden)}
    return head, proj


def test_oft_aux_round_trip_both_ways(tmp_path):
    """JAX writes, the port reads (the newest step by number, the shapes from
    the tensors); the port writes, JAX reads; the head's math is JAX's."""
    head, proj = _oft_tree(np.random.RandomState(5))
    j_ckpt.save_oft_aux_params(str(tmp_path / "a"), head, proj, step=9)
    old, _ = _oft_tree(np.random.RandomState(6))
    j_ckpt.save_oft_aux_params(str(tmp_path / "a"), old, None, step=10)
    j_ckpt.save_oft_aux_params(str(tmp_path / "a"), head, None, step=11)
    th, tp = t_ckpt.load_oft_aux_params(str(tmp_path / "a"), "cpu", torch.float32)
    assert len(th.mlp_resnet_blocks) == 2 and th.fc1.in_features == 12
    pairs = list(t_ckpt.action_head_pairs(th, head))
    for param, arr in pairs:
        np.testing.assert_array_equal(param.detach().numpy(), np.asarray(arr))
    assert len(pairs) == len(list(th.parameters()))
    np.testing.assert_array_equal(tp.fc1.weight.detach().numpy(), proj["fc1_w"].T)
    np.testing.assert_array_equal(tp.fc2.bias.detach().numpy(), proj["fc2_b"])
    x = np.random.RandomState(7).randn(3, 12).astype(np.float32)
    ref = j_model.oft_action_head_forward(jax.tree.map(jnp.asarray, head), jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(th(torch.from_numpy(x)).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    t_ckpt.save_oft_aux_params(str(tmp_path / "b"), th, tp, step=3)
    jh, jp = j_ckpt.load_oft_aux_params(str(tmp_path / "b"), jnp.float32)
    _same_tree(jh, head)
    _same_tree(jp, proj)
    assert t_ckpt.load_oft_aux_params(str(tmp_path / "c"), "cpu") == (None, None)


def test_oft_build_from_snapshot_loads_the_head(tmp_path):
    """An OFT snapshot with aux files: build_openvla loads the head and the
    proprio projector instead of drawing them; the chunk is JAX's."""
    spec = t_model.OpenVLASpec.tiny()
    write_snapshot(tmp_path, spec, seed=8)
    h, n_tok = spec.llama.hidden_size, 2 * spec.action_dim
    head, _ = _oft_tree(np.random.RandomState(9), n_tok * h, h, n_tok)
    _, proj = _oft_tree(np.random.RandomState(10), hidden=h)
    j_ckpt.save_oft_aux_params(str(tmp_path), head, proj)
    kw = dict(oft=True, chunk_len=2, use_proprio=True, proprio_dim=5)
    built = t_build.build_openvla(str(tmp_path), device="cpu", dtype=torch.float32, **kw)
    jb = j_build.build_openvla(str(tmp_path), dtype=jnp.float32, **kw)
    ids = np.array([[1, 500, 900]], np.int32)
    px = np.random.RandomState(11).rand(1, 6, 28, 28).astype(np.float32)
    pr = np.random.RandomState(12).randn(1, 5).astype(np.float32)
    out = built.model.predict_action(ids, px, "bridge_orig", pr)
    ref = jb.model.predict_action(jb.params, ids, px, "bridge_orig", pr)
    assert out.shape == (2, 7)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_norm_stats_and_unnorm_key_match_jax(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "dataset_statistics.json").write_text(json.dumps(STATS))
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "config.json").write_text(json.dumps({"norm_stats": {"x": STATS["fractal"]}}))
    (tmp_path / "c").mkdir()
    for d in "abc":
        p = str(tmp_path / d)
        assert t_ckpt.load_norm_stats(p) == j_ckpt.load_norm_stats(p)
        assert t_ckpt.load_dataset_statistics(p) == j_ckpt.load_dataset_statistics(p)
    assert t_ckpt.load_norm_stats(str(tmp_path / "b")) == {"x": STATS["fractal"]}
    assert t_ckpt.load_dataset_statistics(str(tmp_path / "b")) is None
    norm = {"custom": {}, "bridge_orig": {}, "fractal": {}}
    for requested, ds, prefer in ((None, None, False), (None, {"fractal": {}}, False),
                                  (None, {"fractal": {}}, True), ("custom", None, False),
                                  (None, {"nope": {}}, True)):
        assert (t_ckpt.infer_unnorm_key(norm, requested, ds, prefer)
                == j_ckpt.infer_unnorm_key(norm, requested, ds, prefer))
    assert t_ckpt.infer_unnorm_key({"custom": {}}) == "custom"
    assert t_ckpt.infer_unnorm_key({}) is None
    with pytest.raises(KeyError, match="nope"):
        t_ckpt.infer_unnorm_key(norm, "nope")


@pytest.mark.parametrize("model_id", ["random", "random-minivla-tiny"])
def test_build_random_ids_and_quantization(model_id):
    """Checkpoint-free ids build the spec JAX builds; quantization swaps
    every LLM linear and the head (a tied one materialized)."""
    for quant, kind in ((None, "Linear"), ("none", "Linear"), ("w8a8", "W8A8Linear"),
                        ("w4a8", "W4A8Linear")):
        built = t_build.build_openvla(model_id, device="cpu", dtype=torch.float32,
                                      quantization=quant)
        assert repr(built.spec) == repr(j_model.RANDOM_SPECS[model_id]())
        assert built.tokenizer is None and built.norm_stats is None
        llama = built.model.llama
        assert type(llama.layers[0].gate_proj).__name__ == kind
        assert t_build._llama_has_quant_dicts(llama) == (kind != "Linear")
        if kind != "Linear":
            assert type(llama.lm_head).__name__ == kind
        assert t_build.llama_has_w4a8(llama) == (quant == "w4a8")
        assert not t_build._llama_has_lora_dicts(llama)


def test_build_memory_safe_quant_init_for_32_layers(monkeypatch):
    """With ``memory_safe_quant_init`` a checkpoint-free LLM is built
    quantized directly (no fp LLM linear ever exists), at 32 layers as at
    the tiny spec's depth; without it, quantized after an fp draw."""
    spec = t_model.OpenVLASpec.tiny()
    deep = t_model.OpenVLASpec(
        llama=type(spec.llama)(**{**spec.llama.__dict__, "num_layers": 32}),
        dinov2=spec.dinov2, siglip=spec.siglip)
    monkeypatch.setitem(t_model.RANDOM_SPECS, "deep", lambda: deep)
    for model_id, depth in (("deep", 32), ("random", spec.llama.num_layers)):
        for quant in ("w8a8", "w4a8"):
            built = t_build.build_openvla(model_id, device="cpu", dtype=torch.float32,
                                          quantization=quant, memory_safe_quant_init=True)
            llama = built.model.llama
            assert not any(isinstance(m, torch.nn.Linear) for m in llama.modules())
            kind = {"w8a8": "W8A8Linear", "w4a8": "W4A8Linear"}[quant]
            assert len(llama.layers) == depth and type(llama.lm_head).__name__ == kind
            assert type(llama.layers[0].down_proj).__name__ == kind


def test_snapshot_loads_through_the_writers_key_map(tmp_path, monkeypatch):
    """build_openvla reads a snapshot into the modules tensor by tensor: no
    stacked tree is built (torch.stack is never called), the weights are
    the file's; a missing key and a head the tied model cannot take are
    named."""
    spec = t_model.OpenVLASpec.tiny()
    state = write_snapshot(tmp_path, spec, seed=13)

    def no_stack(*a, **k):
        raise AssertionError("the loader stacked a tree")

    with monkeypatch.context() as m:
        m.setattr(torch, "stack", no_stack)
        model = t_build.build_openvla(str(tmp_path), device="cpu", dtype=torch.float32).model
    keys = t_ckpt.openvla_hf_state_dict(model)
    assert all(torch.equal(t.detach(), state[k].float()) for k, t in keys.items())
    bad = tmp_path / "bad"
    bad.mkdir()
    del state["language_model.model.norm.weight"]
    save_safetensors(state, str(bad / "model.safetensors"))
    with pytest.raises(KeyError, match="model.norm.weight"):
        t_ckpt.load_openvla_hf_dir(t_model.OpenVLA(spec, device="cpu", dtype=torch.float32),
                                   str(bad))
    tied = t_model.OpenVLA(t_model.OpenVLASpec(
        llama=type(spec.llama)(**{**spec.llama.__dict__, "tie_word_embeddings": True}),
        dinov2=spec.dinov2, siglip=spec.siglip), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="tied"):
        t_ckpt.load_openvla_hf_dir(tied, str(tmp_path))


def test_build_errors_match_jax(tmp_path):
    for bad in (dict(model_id="nope"), dict(model_id="random", quantization="int3")):
        with pytest.raises(ValueError) as jerr:
            j_build.build_openvla(**bad, dtype=jnp.float32)
        with pytest.raises(ValueError) as terr:
            t_build.build_openvla(**bad, device="cpu", dtype=torch.float32)
        assert str(terr.value) == str(jerr.value)
    # a directory that is not a parameter tree of the port (e.g. JAX's orbax)
    with pytest.raises(ValueError, match="not a parameter tree of the port"):
        t_build.build_openvla("random", device="cpu", checkpoint_path=str(tmp_path))


def test_guards_on_jax_trees():
    """The three guards on JAX-layout trees agree with JAX's."""
    from blurr_tpu.models.openvla.llama import quantize_llama_w4a8, quantize_llama_w8a8

    fp = j_model.OpenVLA(j_model.OpenVLASpec.tiny()).init_params(jax.random.PRNGKey(0))["llama"]
    lora = {"layers": {"q_w": {"w": np.zeros((2, 2)), "lora_a": np.zeros((2, 1))}}}
    for tree in (fp, quantize_llama_w8a8(fp), quantize_llama_w4a8(fp), lora):
        for name in ("_llama_has_quant_dicts", "llama_has_w4a8", "_llama_has_lora_dicts"):
            assert getattr(t_build, name)(tree) == getattr(j_build, name)(tree), name


def test_snapshot_written_by_the_port_reads_back_in_jax_and_the_port(tmp_path):
    """save_openvla_snapshot writes what JAX's bridge and build_openvla read
    back to the same weights; a quantized LLM is refused."""
    model = t_build.build_openvla("random", device="cpu", dtype=torch.float32, seed=3).model
    t_ckpt.save_openvla_snapshot(model, str(tmp_path), STATS)
    jspec = j_model.OpenVLASpec.from_snapshot_dir(tmp_path)
    assert repr(jspec) == repr(model.spec)
    tree = jax.tree.map(np.asarray, j_ckpt.openvla_params_from_hf_dir(str(tmp_path), jspec,
                                                                      jnp.float32))
    fresh = t_model.OpenVLA(model.spec, device="cpu", dtype=torch.float32)
    t_ckpt.load_jax_params(fresh, tree)
    back = t_build.build_openvla(str(tmp_path), device="cpu", dtype=torch.float32).model
    assert back.norm_stats == STATS
    want = dict(model.named_parameters())
    for other in (fresh, back):
        got = dict(other.named_parameters())
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    quantize_llama_w8a8(model.llama)
    with pytest.raises(ValueError, match="before quantizing"):
        t_ckpt.openvla_hf_state_dict(model)
