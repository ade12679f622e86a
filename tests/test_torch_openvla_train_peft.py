"""The OpenVLA trainer's data and adapter files against the JAX package on
the CPU: ``models/openvla/data.py`` (``write_openvla_dataset``,
``OpenVLATrainTransform``) and the PEFT half of ``ops/lora.py``
(``save_peft_adapter``, ``merge_peft_adapter_into_llama``,
``_adapter_already_merged``, ``maybe_merge_lora_adapter``).

The same factors on both sides: a JAX-layout tiny LLM whose adapters are
numpy draws (B non-zero, one layer's scale different from the others, so
``save_peft_adapter`` folds it into that layer's B), copied into the port's
``Llama`` with the adapters injected the same way. Directories are written
in ``tmp_path``; each package merges the other's. fp32 throughout.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax

from blurr_tpu.models.openvla import data as j_data
from blurr_tpu.models.openvla import llama as j_llama
from blurr_tpu.models.openvla import model as j_model
from blurr_tpu.ops import lora as j_lora
from blurr_tpu_torch.models.openvla import data as t_data
from blurr_tpu_torch.models.openvla import model as t_model
from blurr_tpu_torch.models.openvla.checkpoint import llama_pairs
from blurr_tpu_torch.models.openvla.llama import LAYER_LINEARS, Llama
from blurr_tpu_torch.models.pi0.checkpoint import copy_pairs, read_safetensors
from blurr_tpu_torch.ops import lora as t_lora

MERGE_TOL = 1e-6
RANK = 3
TARGETS = ("q_w", "v_w", "gate_w", "down_w")


def _jax_llama(seed=0):
    """A JAX-layout tiny LLM (numpy) with adapters on TARGETS: A, B drawn,
    layer 1's scale 0.5 where the others' is 2."""
    spec = j_model.OpenVLASpec.tiny().llama
    base = jax.tree.map(np.asarray, j_llama.init_llama_params(jax.random.PRNGKey(seed), spec))
    rng = np.random.RandomState(seed)
    layers = dict(base["layers"])
    for key in TARGETS:
        n, din, dout = layers[key].shape
        layers[key] = {"w": layers[key],
                       "lora_a": rng.randn(n, din, RANK).astype(np.float32) * RANK**-0.5,
                       "lora_b": rng.randn(n, RANK, dout).astype(np.float32) * 0.05,
                       "lora_s": np.array([2.0, 0.5][:n], np.float32)}
    return dict(base, layers=layers)


def _port_llama(tree, lora=True):
    spec = t_model.OpenVLASpec.tiny().llama
    llama = Llama(spec, device="cpu", dtype=torch.float32)
    if lora:
        t_lora.inject_lora_tree(llama, torch.Generator().manual_seed(0), RANK, TARGETS)
    copy_pairs(llama, llama_pairs(llama, tree))
    return llama


def _plain(tree):
    """The tree with each adapter dict replaced by its base weight."""
    return dict(tree, layers={k: v["w"] if j_lora.is_lora_dict(v) else v
                              for k, v in tree["layers"].items()})


def _weights(llama):
    """{JAX key: [L, in, out]} of the port LLM's projections."""
    keys = dict(zip(LAYER_LINEARS, ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")))
    return {keys[a]: np.stack([getattr(layer, a).weight.detach().numpy().T
                               for layer in llama.layers]) for a in LAYER_LINEARS}


def test_save_peft_adapter_matches_jax(tmp_path):
    tree = _jax_llama()
    n_jax = j_lora.save_peft_adapter(tree["layers"], str(tmp_path / "jax"))
    n_port = t_lora.save_peft_adapter(_port_llama(tree), str(tmp_path / "port"))
    assert n_jax == n_port == len(TARGETS) * 2
    theirs = read_safetensors(str(tmp_path / "jax" / "adapter_model.safetensors"))
    ours = read_safetensors(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert ours.keys() == theirs.keys()
    assert "base_model.model.language_model.model.layers.1.mlp.down_proj.lora_B.weight" in ours
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    cfg = (tmp_path / "port" / "adapter_config.json").read_text()
    assert cfg == (tmp_path / "jax" / "adapter_config.json").read_text()
    assert json.loads(cfg)["target_modules"] == ["down_proj", "gate_proj", "q_proj", "v_proj"]
    with pytest.raises(ValueError, match="no LoRA adapters"):
        t_lora.save_peft_adapter(_port_llama(_plain(tree), lora=False), str(tmp_path / "none"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_merges_the_others_directory(tmp_path, writer):
    tree = _jax_llama(1)
    adapter = str(tmp_path / "lora_adapter")
    if writer == "jax":
        j_lora.save_peft_adapter(tree["layers"], adapter)
    else:
        t_lora.save_peft_adapter(_port_llama(tree), adapter)
    base = _plain(tree)
    theirs = j_lora.merge_peft_adapter_into_llama(jax.tree.map(np.asarray, base), adapter,
                                                  dtype=np.float32)
    module = t_lora.merge_peft_adapter_into_llama(_port_llama(base, lora=False), adapter)
    # the port merges JAX-layout trees of tensors too (openvla_params_from_hf_dir)
    t_tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), base)
    t_lora.merge_peft_adapter_into_llama(t_tree, adapter)
    got = _weights(module)
    for key in got:
        want = np.asarray(theirs["layers"][key])
        np.testing.assert_allclose(got[key], want, rtol=0, atol=MERGE_TOL, err_msg=key)
        np.testing.assert_allclose(t_tree["layers"][key].numpy(), want, rtol=0, atol=MERGE_TOL)
        changed = not np.array_equal(want, base["layers"][key])
        assert changed == (key in TARGETS), key
    # the merge is the adapter's forward: W + s * A @ B per layer
    for key in TARGETS:
        d = tree["layers"][key]
        delta = np.einsum("lir,lro->lio", d["lora_a"], d["lora_b"]) * d["lora_s"][:, None, None]
        np.testing.assert_allclose(got[key], d["w"] + delta, rtol=0, atol=MERGE_TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_already_merged_is_detected_both_ways(tmp_path, writer, caplog):
    """A base that already holds the delta is left as it is (with the
    warning) by both packages; an unmerged one is merged by both."""
    tree = _jax_llama(2)
    adapter = str(tmp_path / "lora_adapter")
    if writer == "jax":
        j_lora.save_peft_adapter(tree["layers"], adapter)
    else:
        t_lora.save_peft_adapter(_port_llama(tree), adapter)
    merged = j_lora.merge_peft_adapter_into_llama(jax.tree.map(np.asarray, _plain(tree)),
                                                  adapter, dtype=np.float32)
    merged = jax.tree.map(np.asarray, merged)
    with caplog.at_level(logging.WARNING):
        again_jax = j_lora.merge_peft_adapter_into_llama(merged, adapter, dtype=np.float32)
        port = _port_llama(merged, lora=False)
        before = _weights(port)
        t_lora.merge_peft_adapter_into_llama(port, adapter)
    assert sum("already contain the LoRA adapter" in r.getMessage() for r in caplog.records) == 2
    assert again_jax is merged
    after = _weights(port)
    assert all(np.array_equal(after[k], before[k]) for k in after)
    # the coefficient test itself, on the same sample
    scale, per = t_lora._read_peft(adapter)
    assert t_lora._adapter_already_merged(t_lora._weight_of(port), per, scale)
    fresh = _port_llama(_plain(tree), lora=False)
    assert not t_lora._adapter_already_merged(t_lora._weight_of(fresh), per, scale)


def test_unreadable_adapter_loads_unmerged_with_a_warning(tmp_path, caplog):
    """An empty lora_adapter/ (no config, no weights): both packages warn
    and keep the weights as they are."""
    (tmp_path / "lora_adapter").mkdir()
    tree = _plain(_jax_llama(3))
    with caplog.at_level(logging.WARNING):
        out_jax = j_lora.maybe_merge_lora_adapter(jax.tree.map(np.asarray, tree), str(tmp_path))
        port = _port_llama(tree, lora=False)
        before = _weights(port)
        assert t_lora.maybe_merge_lora_adapter(port, str(tmp_path)) is port
    failed = [r for r in caplog.records if "LoRA merge failed" in r.getMessage()]
    assert len(failed) == 2 and out_jax["layers"]["q_w"] is not None
    after = _weights(port)
    assert all(np.array_equal(after[k], before[k]) for k in after)
    # a quantized LLM cannot take the merge either: the same warning
    from blurr_tpu_torch.models.openvla.llama import quantize_llama_w8a8

    t_lora.save_peft_adapter(_port_llama(_jax_llama(3)), str(tmp_path / "q" / "lora_adapter"))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        t_lora.maybe_merge_lora_adapter(quantize_llama_w8a8(port), str(tmp_path / "q"))
    assert any("fp weights only" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _raw(n, seed=0, chunk=None, proprio=False):
    rng = np.random.RandomState(seed)
    phrases = ["pick up the carrot", "put the spoon on the towel", "stack the green block"]
    shape = (n, 7) if chunk is None else (n, chunk, 7)
    out = {"images": rng.randint(0, 256, (n, 40, 52, 3), np.uint8),
           "instructions": [phrases[i % 3] for i in range(n)],
           "actions": np.clip(rng.randn(*shape) * 0.5, -1, 1).astype(np.float32)}
    if proprio:
        out["proprios"] = rng.randn(n, 5).astype(np.float32)
    return out


@pytest.mark.parametrize("oft", [False, True])
def test_dataset_and_transform_match_jax(tmp_path, oft):
    """The same shards from both writers (each instruction tokenized by the
    same stub within this process), and the same trainer batch from both
    transforms over the port's loader."""
    from blurr_tpu.data import ShardedDataset as JDataset
    from blurr_tpu_torch.data import ShardedBatchLoader, ShardedDataset

    raw = _raw(7, chunk=2 if oft else None, proprio=oft)
    kw = dict(max_text_tokens=24, shard_size=3)
    proprios = raw.get("proprios")
    j_data.write_openvla_dataset(tmp_path / "j", raw["images"], raw["instructions"],
                                 raw["actions"], proprios=proprios, **kw)
    t_data.write_openvla_dataset(tmp_path / "t", raw["images"], raw["instructions"],
                                 raw["actions"], proprios=proprios, **kw)
    idx = np.arange(7)
    a, b = ShardedDataset(tmp_path / "t").gather_batch(idx), JDataset(tmp_path / "j").gather_batch(idx)
    assert a.keys() == b.keys() == ({"image", "instruction_ids", "instruction_len", "action"}
                                    | ({"proprio"} if oft else set()))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    spec = t_model.OpenVLASpec.tiny()
    jt = j_data.OpenVLATrainTransform(j_model.OpenVLA(j_model.OpenVLASpec.tiny()), 28, True,
                                      oft=oft, use_proprio=oft)
    tt = t_data.OpenVLATrainTransform(t_model.OpenVLA(spec, device="meta", dtype=torch.float32),
                                      28, True, oft=oft, use_proprio=oft)
    loader = ShardedBatchLoader(tmp_path / "t", 4, seed=3, transform=tt)
    rows = loader._epoch_perm(0)[:4]
    got, want = loader.next_batch(), jt(JDataset(tmp_path / "j").gather_batch(rows))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not oft:  # the labels sit right after each prompt
        lens = a["instruction_len"][rows]
        for r in range(4):
            np.testing.assert_array_equal(got["input_ids"][r, lens[r]:lens[r] + 7],
                                          got["labels"][r])
    with pytest.raises(ValueError, match="instructions"):
        t_data.write_openvla_dataset(tmp_path / "bad", raw["images"][:3], raw["instructions"],
                                     raw["actions"])
