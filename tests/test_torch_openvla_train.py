"""The port's OpenVLA training losses (``OpenVLA.action_ce_loss``,
``OpenVLAOFT.oft_l1_loss``) and their gradients against the JAX package on
the CPU.

Same weights on both sides: JAX's ``init_params`` (every float leaf
perturbed from a numpy seed), its LLM quantized w8a8 / w4a8 where the case
says, LoRA adapters injected on all seven projections with B drawn non-zero
(B = 0 at injection would make A's gradient zero), then copied into the
port model built the same way by ``load_jax_params``. The inputs are a
ragged batch of two from numpy seeds. JAX's gradients come from
``value_and_grad_frozen_int``; its w4a8 product dequantizes off the TPU,
the port's runs its int4 kernel's plain version (the same values to fp32
rounding), both straight-through in the backward.

Bounds: the loss within LOSS_RTOL (1e-6) relative; every trainable leaf
(the factors, and OFT's head and proprio projector) within GRAD_REL_TOL
(1e-4) of that leaf's largest |grad|. Two planted faults must read over
the bound: the label rows gathered one position late, and OFT's
bidirectional block that leaves out the placeholders (they attend
causally). The test prints the readings (``-s``).
"""

import functools
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.openvla import llama as j_llama
from blurr_tpu.models.openvla import model as j_model
from blurr_tpu.ops import lora as j_lora
from blurr_tpu.utils import optim as j_optim
from blurr_tpu_torch.models.openvla import llama as t_llama
from blurr_tpu_torch.models.openvla import model as t_model
from blurr_tpu_torch.models.openvla.checkpoint import _pairs, load_jax_params
from blurr_tpu_torch.models.pi0.trainable import apply_mask
from blurr_tpu_torch.ops import lora as t_lora

LOSS_RTOL = 1e-6
GRAD_REL_TOL = 1e-4
TOL = 1e-5
RANK = 2
ALPHA = 4.0
# B ~ N(0, B_SCALE^2): deltas of the size training gives the adapters. At
# 0.3 (with s = 2) the deltas outgrow the weights and the gradients turn
# ill-conditioned: JAX's and the port's fp32 gradients then sit 1.3e-4 and
# 3.1e-4 from the same model evaluated in fp64, so the bound could not tell
# rounding from a fault there
B_SCALE = 0.05
CHUNK = 2
PROPRIO = 5
TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
# (spec, objective, LLM base)
CASES = [("tiny", "ar", "fp"), ("tiny", "ar", "w8a8"), ("tiny", "ar", "w4a8"),
         ("tiny", "oft", "fp"), ("tiny", "oft", "w8a8"), ("tiny", "oft", "w4a8"),
         ("tiny_minivla", "ar", "fp")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, rng, scale=0.05):
    def f(a):
        a = np.asarray(a)
        return a if a.dtype.kind != "f" else (a + scale * rng.randn(*a.shape)).astype(a.dtype)

    return jax.tree.map(f, tree)


def _nonzero_b(tree, rng):
    if j_lora.is_lora_dict(tree):
        b = rng.randn(*np.shape(tree["lora_b"])) * B_SCALE
        return {**tree, "lora_b": b.astype(np.float32)}
    if isinstance(tree, dict):
        return {k: _nonzero_b(v, rng) for k, v in tree.items()}
    return tree


def _jax_model(name, objective):
    spec = getattr(j_model.OpenVLASpec, name)()
    if objective == "oft":
        return j_model.OpenVLAOFT(spec, chunk_len=CHUNK, use_proprio=True, proprio_dim=PROPRIO)
    return j_model.OpenVLA(spec)


def _inputs(jm, objective, seed=1):
    """A ragged batch of two: row 1's prompt two tokens shorter. AR: the
    labels appended after each prompt; OFT: right-padded prompts, target
    chunks and proprio."""
    spec = jm.spec
    rng = np.random.RandomState(seed)
    b, n_prompt = 2, 9
    c = 6 if spec.use_fused_vision else 3
    px = rng.rand(b, c, 28, 28).astype(np.float32)
    lens = (n_prompt, n_prompt - 2)
    if objective == "oft":
        ids = np.zeros((b, n_prompt), np.int32)
        valid = np.zeros_like(ids)
        for r, n in enumerate(lens):
            ids[r, :n] = rng.randint(3, 31000, n)
            ids[r, 0] = 1
            valid[r, :n] = 1
        actions = np.clip(rng.randn(b, CHUNK, spec.action_dim) * 0.5, -1, 1).astype(np.float32)
        proprio = rng.randn(b, PROPRIO).astype(np.float32)
        return {"ids": ids, "valid": valid, "px": px, "actions": actions, "proprio": proprio}
    seq = n_prompt + spec.action_dim
    ids = np.zeros((b, seq), np.int32)
    valid = np.zeros_like(ids)
    labels = jm.tokenize_actions(np.clip(rng.randn(b, spec.action_dim) * 0.5, -1, 1))
    for r, n in enumerate(lens):
        ids[r, :n] = rng.randint(3, 31000, n)
        ids[r, 0] = 1
        ids[r, n:n + spec.action_dim] = labels[r]
        valid[r, :n + spec.action_dim] = 1
    return {"ids": ids, "valid": valid, "px": px, "labels": labels}


@functools.lru_cache(maxsize=None)
def _base_tree(name):
    """JAX's perturbed fp tree of the OFT model (with proprio); the AR
    model's is the same less the OFT modules."""
    jm = _jax_model(name, "oft")
    return _perturb(_np(jax.jit(jm.init_params)(jax.random.PRNGKey(0))), np.random.RandomState(0))


@functools.lru_cache(maxsize=None)
def _llama_tree(name, base):
    """The LLM's tree quantized as ``base`` says, with adapters on all seven
    projections and B drawn non-zero."""
    llama = jax.tree.map(jnp.asarray, _base_tree(name)["llama"])
    if base != "fp":
        qfn = {"w8a8": j_llama.quantize_llama_w8a8, "w4a8": j_llama.quantize_llama_w4a8}[base]
        llama = jax.jit(qfn)(llama)
    llama = dict(llama)
    rng = jax.random.PRNGKey(7)
    llama["layers"] = jax.jit(lambda t: j_lora.inject_lora_tree(t, rng, RANK, TARGETS, ALPHA))(
        llama["layers"])
    return _nonzero_b(_np(llama), np.random.RandomState(1))


def _case(name, objective, base):
    """(JAX model, its numpy tree, inputs)."""
    jm = _jax_model(name, objective)
    params = {k: v for k, v in _base_tree(name).items()
              if objective == "oft" or k not in ("action_head", "proprio_projector")}
    params["llama"] = _llama_tree(name, base)
    return jm, params, _inputs(jm, objective)


def _jax_loss(jm, objective, p, inp):
    if objective == "oft":
        return jm.oft_l1_loss(p, inp["ids"], inp["px"], inp["actions"], inp["proprio"],
                              attn_valid=inp["valid"])
    return jm.action_ce_loss(p, inp["ids"], inp["valid"], inp["px"], inp["labels"])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name, objective, base):
    """JAX's loss and its gradients of the LLM (int bases frozen) and the
    OFT modules; the vision towers and projector enter as constants."""
    jm, params, inp = _case(name, objective, base)
    params = jax.tree.map(jnp.asarray, params)
    keys = ("llama", "action_head", "proprio_projector") if objective == "oft" else ("llama",)
    wrt = {k: params[k] for k in keys}
    fn = j_optim.value_and_grad_frozen_int(
        lambda p: _jax_loss(jm, objective, {**params, **p}, inp))
    loss, grads = jax.jit(fn)(wrt)
    return float(loss), _np({**params, **grads})


def _port(name, objective, base):
    """The port model on the case's weights, built as JAX's tree is."""
    jm, params, _ = _case(name, objective, base)
    spec = getattr(t_model.OpenVLASpec, name)()
    if objective == "oft":
        model = t_model.OpenVLAOFT(spec, None, CHUNK, True, PROPRIO, device="cpu",
                                   dtype=torch.float32)
    else:
        model = t_model.OpenVLA(spec, device="cpu", dtype=torch.float32)
    if base != "fp":
        {"w8a8": t_llama.quantize_llama_w8a8, "w4a8": t_llama.quantize_llama_w4a8}[base](
            model.llama)
    t_lora.inject_lora_tree(model.llama, torch.Generator().manual_seed(0), RANK, TARGETS, ALPHA)
    load_jax_params(model, params)
    mask = t_lora.lora_trainable_mask(model)
    mask = {n: m or n.startswith(("action_head.", "proprio_projector.")) for n, m in mask.items()}
    apply_mask(model, mask)
    return model


def _port_loss(model, objective, inp, remat=False):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    if objective == "oft":
        return model.oft_l1_loss(t["ids"], t["px"], t["actions"], t["proprio"],
                                 attn_valid=t["valid"], remat=remat)
    return model.action_ce_loss(t["ids"], t["valid"], t["px"], t["labels"], remat=remat)


def _reading(model, jgrads):
    """max over the trainable leaves of max|port - JAX| / max|JAX| of that
    leaf, and the number of leaves compared."""
    pairs = [(p, want) for p, want in _pairs(model, jgrads)
             if isinstance(p, torch.nn.Parameter) and p.requires_grad]
    worst = 0.0
    for p, want in pairs:
        want = np.asarray(want, np.float32)
        got = np.zeros(want.shape, np.float32) if p.grad is None else p.grad.numpy()
        worst = max(worst, np.abs(got - want).max() / np.abs(want).max())
    return worst, len(pairs)


def _loss_and_reading(model, name, objective, base):
    _, _, inp = _case(name, objective, base)
    loss = _port_loss(model, objective, inp)
    loss.backward()
    want, jgrads = _jax_loss_and_grads(name, objective, base)
    reading, n = _reading(model, jgrads)
    return abs(loss.item() - want) / abs(want), reading, n


@pytest.mark.parametrize("name, objective, base", CASES)
def test_loss_and_factor_gradients_match_jax(name, objective, base):
    model = _port(name, objective, base)
    loss_err, reading, n = _loss_and_reading(model, name, objective, base)
    print(f"{name} {objective} {base}: loss rel {loss_err:.2e}, {n} leaves, gradient "
          f"reading {reading:.3e}")
    # 4 factors a projection: the adapters of 7 projections in every layer
    # (and OFT's head and projector)
    n_factors = 2 * 7 * model.spec.llama.num_layers
    assert n >= n_factors and loss_err <= LOSS_RTOL and reading < GRAD_REL_TOL
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert all(n.endswith(("lora_a", "lora_b")) or n.startswith(("action_head.",
                                                                 "proprio_projector."))
               for n in trainable)
    assert all(p.grad is None for p in model.parameters() if not p.requires_grad)


def _planted(method, old: str, new: str):
    """``method`` with one source line replaced, compiled in its module."""
    src = textwrap.dedent(inspect.getsource(method))
    assert src.count(old) == 1, old
    ns = {}
    exec(compile(src.replace(old, new), inspect.getsourcefile(method), "exec"),
         vars(t_model), ns)
    return ns[method.__name__]


def test_planted_faults_read_over_the_bound():
    sound = _loss_and_reading(_port("tiny", "ar", "w4a8"), "tiny", "ar", "w4a8")
    model = _port("tiny", "ar", "w4a8")
    model.action_ce_loss = types.MethodType(_planted(
        t_model.OpenVLA.action_ce_loss, "n_patch + n_prompt[:, None] - 1",
        "n_patch + n_prompt[:, None]"), model)
    late = _loss_and_reading(model, "tiny", "ar", "w4a8")
    model = _port("tiny", "oft", "w4a8")
    model.continuous_chunk = types.MethodType(_planted(
        t_model.OpenVLAOFT.continuous_chunk, "act = torch.arange(total, device=dev) >= total - n_tok",
        "act = torch.arange(total, device=dev) > total"), model)
    causal = _loss_and_reading(model, "tiny", "oft", "w4a8")
    print(f"sound (loss rel, grads) {sound[:2]}; labels one row late {late[:2]}; "
          f"placeholders outside the bidirectional block {causal[:2]}")
    assert sound[0] <= LOSS_RTOL and sound[1] < GRAD_REL_TOL
    for fault in (late, causal):
        assert fault[0] > LOSS_RTOL and fault[1] > GRAD_REL_TOL


@pytest.mark.parametrize("objective", ["ar", "oft"])
def test_remat_equals_plain(objective):
    """remat recomputes each layer in the backward: the same loss and
    gradients, and every w4a8 product runs twice."""
    from blurr_tpu_torch.ops import quant as tq

    _, _, inp = _case("tiny", objective, "w4a8")
    calls, real = [], tq.int4_matmul
    out = []
    try:
        tq.int4_matmul = lambda *a: calls.append(1) or real(*a)
        for remat in (False, True):
            model = _port("tiny", objective, "w4a8")
            calls.clear()
            loss = _port_loss(model, objective, inp, remat=remat)
            loss.backward()
            out.append((loss.detach(), [p.grad for p in model.parameters() if p.requires_grad],
                        len(calls)))
    finally:
        tq.int4_matmul = real
    (l0, g0, c0), (l1, g1, c1) = out
    layers = model.spec.llama.num_layers
    # 7 products a layer; AR also runs the head on the label rows
    assert c0 == 7 * layers + (objective == "ar") and c1 == c0 + 7 * layers
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_padded_oft_row_equals_its_solo_forward():
    _, _, inp = _case("tiny", "oft", "fp")
    model = _port("tiny", "oft", "fp")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    both = model.continuous_chunk(t["ids"], t["px"], t["proprio"], t["valid"], train=True)
    n = int(t["valid"][1].sum())
    solo = model.continuous_chunk(t["ids"][1:, :n], t["px"][1:], t["proprio"][1:], None,
                                  train=True)
    torch.testing.assert_close(both[1:], solo, rtol=TOL, atol=TOL)
    with torch.no_grad():  # the serving route's cache gives the training route's values
        served = model.predict_action_continuous(t["ids"], t["px"], t["proprio"], t["valid"])
    torch.testing.assert_close(served, both.detach(), rtol=TOL, atol=TOL)


def test_tokenize_actions_matches_jax():
    rng = np.random.RandomState(4)
    a = np.concatenate([rng.uniform(-1.2, 1.2, (16, 7)), np.array([[-1, 1, 0, -1, 1, 0, 0.5]])])
    jm = j_model.OpenVLA(j_model.OpenVLASpec.tiny())
    tm = t_model.OpenVLA(t_model.OpenVLASpec.tiny(), device="meta", dtype=torch.float32)
    np.testing.assert_array_equal(tm.tokenize_actions(a), jm.tokenize_actions(a))
