"""The port's tensor-parallel sharding (``blurr_tpu_torch/parallel``) against
the JAX package's ``blurr_tpu/parallel/mesh.py``, without processes: a Mesh
with no groups still tells ``shard_params`` which slice a rank holds.

- The rule table: for every weight of the tiny Pi-0 (plain, w8a8, w4a8,
  int8 and a QLoRA tree) and of the tiny OpenVLA (plain and w4a8), the axis
  a rank's slice is cut on equals the axis JAX's ``_spec_for_path`` puts
  'model' on, after the transpose (JAX ``[in, out]`` against ``nn.Linear``'s
  ``[out, in]``; the quantized layouts are JAX's), and the slice holds the
  full model's values there. A w4a8 ``s`` is cut on the same axis over its
  scales padded to NB * BN (the w4a8 rule). JAX's trees are traced for
  their shapes only (``jax.eval_shape``).
- ``repack_w4a8`` is byte-equal to JAX's at 2, 4 and 8 shards and widths
  2,048 / 4,096 / 11,008 / 16,384 over a small K, and lossless;
  ``repack_w4a8_tree`` keeps a tie and the bytes of a layout that divides.
- The helpers: the backend rule, a rank's device and rows, the w4a8
  blocks that skip their gather, ``conditional_decorator`` and
  ``main_rank_only`` with no process group.

The sharded runs (JAX's outputs at tp=2 and 2 x 2, the servers) are in
``tests/test_torch_parallel_serving.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.openvla import llama as j_llama
from blurr_tpu.models.openvla import model as j_vla
from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import lora as j_lora
from blurr_tpu.ops import quant as jq
from blurr_tpu.parallel import mesh as j_mesh
from blurr_tpu_torch.models.openvla import llama as t_llama
from blurr_tpu_torch.models.openvla import model as t_vla
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import lora as t_lora
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.ops.int4_matmul import from_block_major
from blurr_tpu_torch.parallel import mesh as t_mesh
from blurr_tpu_torch.parallel import tensor_parallel as tp
from blurr_tpu_torch.utils.decorator import conditional_decorator, main_rank_only
from tests.util import tiny_pi0_cfg

TP = 2
_MIX = {"q_proj": "q_w", "k_proj": "k_w", "v_proj": "v_w", "o_proj": "o_w",
        "gate_proj": "gate_w", "up_proj": "up_w", "down_proj": "down_w"}
_SIGLIP = {"q_proj": "q_w", "k_proj": "k_w", "v_proj": "v_w", "out_proj": "out_w",
           "fc1": "fc1_w", "fc2": "fc2_w"}
_VIT = {"qkv": "qkv_w", "proj": "out_w", "fc1": "fc1_w", "fc2": "fc2_w"}
_QUANT_LEAVES = {"q4", "s", "q", "q8a", "fp", "lora_a", "lora_b", "lora_s"}
LORA_TARGETS = ("q_w", "v_w", "o_w", "down_w", "fc1_w", "fc2_w")


def jax_path(name: str):
    """A port state-dict name -> (JAX tree path, "plain" for a transposed
    [out, in] matrix, "same" for a leaf in JAX's layout), or None where the
    name is no weight of the rule table (norms, biases, scalars)."""
    parts = name.split(".")
    if name in ("embed_tokens", "llama.embed_tokens"):
        return "/" + name.replace(".", "/"), "same"
    if parts[0] == "joint" and len(parts) > 5 and parts[4] in _MIX:
        mixture = "action" if parts[1] == "proprio" else parts[1]  # the port ties them
        prefix, rest = f"/joint/{mixture}/{_MIX[parts[4]]}", parts[5:]
    elif parts[:2] == ["vision_tower", "layers"] and len(parts) > 4 and parts[3] in _SIGLIP:
        prefix, rest = f"/siglip/layers/{_SIGLIP[parts[3]]}", parts[4:]
    elif parts[0] in ("siglip", "dinov2") and parts[1:2] == ["blocks"] and len(parts) > 4 \
            and parts[3] in _VIT:
        prefix, rest = f"/{parts[0]}/layers/{_VIT[parts[3]]}", parts[4:]
    elif parts[:2] == ["llama", "layers"] and len(parts) > 4 and parts[3] in _MIX:
        prefix, rest = f"/llama/layers/{_MIX[parts[3]]}", parts[4:]
    elif parts[:2] == ["llama", "lm_head"]:
        prefix, rest = "/llama/lm_head", parts[2:]
    else:
        return None
    if rest[0] == "base":
        prefix, rest = prefix + "/w", rest[1:]
    if rest == ["weight"]:
        return prefix, "plain"
    if len(rest) == 1 and rest[0] in _QUANT_LEAVES:
        return f"{prefix}/{rest[0]}", "same"
    return None


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def _jax_axis(path, leaf, port_ndim, kind):
    """The port axis JAX's spec splits over 'model' (None: whole)."""
    spec = list(j_mesh._spec_for_path(path, leaf))
    if "model" not in spec:
        return None
    neg = spec.index("model") - len(leaf.shape)
    if kind == "plain":  # JAX [.., in, out] is the port's [out, in]
        return {-1: 0, -2: 1}[neg]
    return port_ndim + neg


def _split_axis(full, local):
    axes = [i for i, (a, b) in enumerate(zip(full.shape, local.shape)) if a != b]
    assert len(axes) <= 1, (full.shape, local.shape)
    return axes[0] if axes else None


def _sharded_state(model, rank):
    """The state dict of a copy of ``model`` sharded for ``rank`` of a
    (1, TP) mesh, under the full model's names (a row layer holds its bias
    itself, also over a LoRA adapter's base)."""
    full = model.state_dict()
    local = t_mesh.shard_params(_copy(model), t_mesh.Mesh(1, TP, rank))
    out = {}
    for k, v in local.state_dict().items():
        k = k.replace(".local.", ".")
        if k.endswith("embed_tokens.weight"):
            k = k[:-len(".weight")]
        if k not in full and k.endswith(".bias"):
            k = k[:-len("bias")] + "base.bias"
        out[k] = v
    blocks = {f"{n}.s".replace(".local.", ".")
              for n, m in local.named_modules(remove_duplicate=False)
              if isinstance(m, tp.W4A8Blocks)}
    return local, out, blocks


def _copy(model):
    import copy

    return copy.deepcopy(model)


def _check_rules(jax_tree, model):
    """Every port tensor, cut for each rank, against JAX's rule; returns
    the JAX paths the port hit."""
    tq.repack_w4a8_tree(model, TP)
    full = model.state_dict()
    hit = set()
    for rank in range(TP):
        _, local, blocks = _sharded_state(model, rank)
        assert local.keys() == full.keys()
        for name, f in full.items():
            if name in blocks:
                nb, _, bn = full[name[:-1] + "q4"].shape  # the scales padded to NB * BN
                f = torch.nn.functional.pad(f, (0, nb * bn - f.shape[1]))
            got = _split_axis(f, local[name])
            mapped = jax_path(name)
            if mapped is None:
                if name.endswith(".bias"):  # a column layer's bias is cut with its output
                    owner = name[:-len(".bias")].replace(".base", "")
                    want = 0 if t_mesh.rule_for(owner) == t_mesh.COLUMN else None
                else:
                    want = None
                assert got == want, (name, f.shape, local[name].shape)
                continue
            path, kind = mapped
            want = _jax_axis(path, _leaf(jax_tree, path), f.dim(), kind)
            assert got == want, (name, path, f.shape, local[name].shape, want)
            hit.add(path)
            if got is None:
                assert torch.equal(f, local[name]), name
                continue
            width = local[name].shape[got]
            assert torch.equal(local[name], f.narrow(got, rank * width, width)), name
    return hit


def _jax_split_paths(tree, prefix=""):
    """Every leaf path of a JAX tree whose spec splits over 'model'."""
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, dict):
            out |= _jax_split_paths(v, p)
        elif v is not None and "model" in tuple(j_mesh._spec_for_path(p, v)):
            out.add(p)
    return out


PI0_TREES = {
    "plain": {},
    "w8a8": {"action_quantization": {"mode": "w8a8"},
             "vlm_quantization": {"mode": "w8a8", "include_vision": True}},
    "w4a8": {"action_quantization": {"mode": "w4a8"},
             "vlm_quantization": {"mode": "w4a8", "include_vision": True}},
    "int8": {"action_quantization": {"mode": "int8", "cache_fp_weight": False},
             "vlm_quantization": {"mode": "w8a8"}},
    "qlora": {"action_quantization": {"mode": "w4a8"},
              "vlm_quantization": {"mode": "w4a8"}},
}


@pytest.mark.parametrize("tree", sorted(PI0_TREES))
def test_rule_table_matches_jax_on_pi0(tree):
    cfg = tiny_pi0_cfg(**PI0_TREES[tree])
    jm = JPiZero(cfg)

    def build():
        p = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
        p = jm.enable_vlm_quantization(jm.enable_action_quantization(p))
        if tree == "qlora":
            p = dict(p)
            p["siglip"] = j_lora.inject_lora_tree(p["siglip"], jax.random.PRNGKey(1), 2,
                                                  LORA_TARGETS)
            p["joint"] = {**p["joint"], **{
                m: j_lora.inject_lora_tree(p["joint"][m], jax.random.PRNGKey(2), 2,
                                           LORA_TARGETS) for m in ("vlm", "action")}}
        return p

    params = jax.eval_shape(build)
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    model.enable_action_quantization()
    model.enable_vlm_quantization()
    if tree == "qlora":
        g = torch.Generator().manual_seed(1)
        for mod in (model.vision_tower, model.joint["vlm"], model.joint["action"]):
            t_lora.inject_lora_tree(mod, g, 2, LORA_TARGETS)
    hit = _check_rules(params, model)
    want = {p for p in _jax_split_paths(params) if not p.startswith("/joint/proprio")}
    assert hit >= want, sorted(want - hit)
    # the tie survives the sharding
    local, _, _ = _sharded_state(model, 0)
    assert local.joint["proprio"] is local.joint["action"]


@pytest.mark.parametrize("quant", [None, "w4a8"])
def test_rule_table_matches_jax_on_openvla(quant):
    spec = j_vla.OpenVLASpec.tiny()
    jm = j_vla.OpenVLA(spec)

    def build():
        p = jm.init_params(jax.random.PRNGKey(0))
        if quant:
            p = {**p, "llama": j_llama.quantize_llama_w4a8(p["llama"])}
        return p

    params = jax.eval_shape(build)
    model = t_vla.OpenVLA(t_vla.OpenVLASpec.tiny(), device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    if quant:
        t_llama.quantize_llama_w4a8(model.llama)
    hit = _check_rules(params, model)
    assert hit >= _jax_split_paths(params), sorted(_jax_split_paths(params) - hit)


# ---------------------------------------------------------------------------
# repack_w4a8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096, 11008, 16384])
def test_repack_w4a8_byte_equal_to_jax(n, shards):
    k = 32
    w = torch.from_numpy(np.random.RandomState(n + shards).randn(k, n).astype(np.float32))
    tw = tq.quantize_weight_w4a8(w, group_size=16)  # one-shard packing, JAX's bytes
    want = jax.tree.map(np.asarray, jq.repack_w4a8(
        {key: jnp.asarray(v.numpy()) for key, v in tw.items()}, shards))
    got = tq.repack_w4a8(tw, shards)
    assert np.array_equal(got["q4"].numpy(), want["q4"]) and got["q4"].dtype == torch.int8
    assert np.array_equal(got["s"].numpy(), want["s"])
    assert got["q4"].shape[0] % shards == 0
    # lossless: the same nibbles in every real column, zeros past them
    flat = from_block_major(got["q4"])
    assert torch.equal(flat[:, :n], from_block_major(tw["q4"])[:, :n])
    assert not flat[:, n:].any()


def test_repack_w4a8_tree_keeps_ties_and_divisible_layouts():
    lin = torch.nn.Linear(64, 2816, bias=False)  # 2 blocks of 1408: divides 2
    odd = torch.nn.Linear(64, 1500, bias=False)  # 3 blocks of 512
    a, b = tq.W4A8Linear.from_linear(lin), tq.W4A8Linear.from_linear(odd)
    root = torch.nn.ModuleDict({"a": a, "b": b, "tied": b})
    before_a, before_b = a.q4, b.q4
    tq.repack_w4a8_tree(root, 2)
    assert a.q4 is before_a  # already divides: the same bytes
    assert b.q4 is not before_b and b.q4.shape[0] % 2 == 0
    assert root["tied"] is root["b"]
    assert tq.repack_w4a8_tree(root, 1) is root
    assert tq.repack_w4a8({"q4": a.q4, "s": a.s}, 2)["q4"] is a.q4


# ---------------------------------------------------------------------------
# The helpers
# ---------------------------------------------------------------------------


def test_backend_and_device_rule():
    assert t_mesh.pick_backend(torch.device("cpu"), 4) == "gloo"
    assert t_mesh.rank_device("cpu", 3) == torch.device("cpu")


def test_data_rows_and_one_rank_collectives():
    x = torch.arange(8).reshape(4, 2)
    mesh = t_mesh.Mesh(data=2, model=2, rank=3)  # data row 1, model rank 1
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    assert torch.equal(t_mesh.data_rows(x, mesh), x[2:])
    with pytest.raises(ValueError, match="does not split"):
        t_mesh.data_rows(x[:3], mesh)
    for fn in (t_mesh.all_reduce_sum, t_mesh.all_reduce_max, t_mesh.all_gather):
        assert fn(x, None) is x  # a group of one rank: the identity


@pytest.mark.parametrize("n,gathers", [(2048, False), (2000, True)])
def test_w4a8_blocks_skip_the_gather_only_where_blocks_are_columns(n, gathers):
    lin = tq.W4A8Linear.from_linear(torch.nn.Linear(64, n, bias=False))
    tq.repack_w4a8_tree(lin, 2)
    col = tp.parallel_linear(lin, t_mesh.COLUMN, t_mesh.Mesh(1, 2, 1))
    assert col.local.gathers is gathers and col.out_features == n // 2
    if not gathers:  # no group is ever asked for: the rank's columns alone
        x = torch.randn(3, 64)
        torch.testing.assert_close(col(x), lin(x)[:, n // 2:], rtol=0, atol=0)


def test_decorators_without_a_process_group():
    calls = []
    assert main_rank_only(lambda: calls.append(1) or "ran")() == "ran"
    assert conditional_decorator(main_rank_only, False)(len) is len
    assert conditional_decorator(lambda f: "wrapped", True)(len) == "wrapped"
    assert calls == [1]
