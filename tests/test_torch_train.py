"""The port's flow-matching training (``PiZero.flow_loss``, its gradients
through the straight-through quantized products, the training step, the
schedules and the casts) against the JAX package on the CPU.

Same weights on both sides (JAX ``init_params`` -> the canonical tied tree,
quantized and given adapters as ``scripts/train_pi0_flow.py`` does them,
then copied into the port by ``load_jax_params``), the same numpy inputs,
flow time and noise. JAX's w4a8 product takes its dequantizing route off
the TPU (``blurr_tpu/ops/quant.py:375-381``), the port its plain int4
product: the same values up to fp32 rounding.

Two trees carry every case: 'fp' (full fine-tuning, each scope) and
'lora': adapters over fp SigLIP weights (LoRA), over a w8a8 vlm mixture
and a w4a8 action mixture (QLoRA), the mixtures' activation clip 0.5.

Gradient bound: every trainable leaf within ``GRAD_REL_TOL`` (1e-4) of its
largest |grad|. SigLIP's key biases, whose gradient is zero in exact
arithmetic (the softmax ignores a constant added to every key; both sides
read ~1e-9 of rounding there), are held below 1e-6 of the model's largest
|grad| instead. The sound readings are 1.0e-6 to 2.9e-6 for the adapters
(through the straight-through products) and 1.6e-6 for scope
action_expert; two planted faults read ~1 (the clip applied to the
adapter branch too: 1.5; the proprio mixture's gradient dropped from the
tied action module: 0.97). The test prints them.
"""

import copy
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import lora as j_lora
from blurr_tpu.ops import quant as jq
from blurr_tpu.utils import optim as j_optim
from blurr_tpu_torch.models.pi0 import checkpoint as t_ckpt
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.trainable import SCOPES, apply_mask
from blurr_tpu_torch.ops import lora as t_lora
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.parallel.train import make_train_step, sample_noise_and_t
from blurr_tpu_torch.utils import optim as t_optim
from tests.util import tiny_inputs, tiny_pi0_cfg

GRAD_REL_TOL = 1e-4
# SigLIP's key bias: the softmax ignores a constant added to every key, so
# its gradient is rounding noise (~1e-9 against a largest |grad| of ~0.07)
ZERO_GRAD_LEAVES = re.compile(r"^vision_tower\.layers\.\d+\.k_proj(\.base)?\.bias$")
ZERO_GRAD_ABS = 1e-6
LOSS_RTOL = 1e-5
RANK = 2
CLIP = 0.5


def _cfg(lora: bool):
    cfg = tiny_pi0_cfg()
    if lora:  # the mixtures' activation clip is on while a tier is set
        cfg["vlm_quantization"] = {"mode": "w8a8", "activation_clip": CLIP}
        cfg["action_quantization"] = {"mode": "w4a8", "activation_clip": CLIP}
    return cfg


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(cfg, JAX model, JAX canonical params, inputs) of 'fp' or 'lora'
    (SigLIP adapted on fp weights; the vlm mixture quantized w8a8 and the
    action mixture w4a8, then adapted, as the JAX trainer's QLoRA does).
    The adapters' B is drawn non-zero, so A's gradient is too."""
    cfg = _cfg(kind == "lora")
    jm = JPiZero(cfg)
    # jitted: one compile each instead of one per eager op, in about a third
    # of the time
    params = _case("fp")[2] if kind == "lora" else jm.canonicalize_tied_weights(
        jm.tie_action_proprio_weights(jax.jit(jm.init_params)(jax.random.PRNGKey(0))))
    if kind != "fp":
        targets = ("q_w", "v_w", "fc1_w", "gate_w", "down_w")
        rng = jax.random.PRNGKey(7)
        inject = jax.jit(lambda tree: j_lora.inject_lora_tree(tree, rng, RANK, targets))
        params = dict(params)
        params["joint"] = dict(params["joint"])
        params["siglip"] = inject(params["siglip"])
        for m, qfn in (("vlm", jq.quantize_mixture_w8a8), ("action", jq.quantize_mixture_w4a8)):
            params["joint"][m] = inject(jax.jit(qfn)(params["joint"][m]))
        b_rng = np.random.RandomState(3)

        def nonzero_b(t):
            if j_lora.is_lora_dict(t):
                return {**t, "lora_b": jnp.asarray(
                    b_rng.randn(*t["lora_b"].shape).astype(np.float32) * 0.3)}
            if isinstance(t, dict):
                return {k: nonzero_b(v) for k, v in t.items()}
            return t

        params = nonzero_b(params)
    inp = tiny_inputs(cfg)
    rng = np.random.RandomState(1)
    inp["actions"] = np.clip(rng.randn(2, 4, 7), -1, 1).astype(np.float32)
    inp["t"] = (rng.rand(2) ** (2 / 3)).astype(np.float32)
    inp["x0"] = rng.randn(2, 4, 7).astype(np.float32)
    return cfg, jm, params, inp


def _jax_args(inp):
    return (inp["input_ids"], inp["attention_mask"], inp["pixel_values"], inp["proprios"],
            inp["actions"], inp["t"], inp["x0"])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(kind):
    _, jm, params, inp = _case(kind)
    args = _jax_args(inp)
    fn = j_optim.value_and_grad_frozen_int(lambda p: jm.flow_loss(p, *args))
    loss, grads = jax.jit(fn)(params)
    return float(loss), _np(grads)


def _port(kind):
    """The port model on the case's JAX weights (structure built the same
    way: mixtures quantized, adapters injected, then the tree copied)."""
    cfg, _, params, _ = _case(kind)
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    if kind != "fp":
        targets = ("q_w", "v_w", "fc1_w", "gate_w", "down_w")
        g = torch.Generator().manual_seed(0)
        t_lora.inject_lora_tree(model.vision_tower, g, RANK, targets)
        for m, quant in (("vlm", tq.quantize_mixture_w8a8),
                         ("action", tq.quantize_mixture_w4a8)):
            quant(model.joint[m].layers)
            t_lora.inject_lora_tree(model.joint[m], g, RANK, targets)
    t_ckpt.load_jax_params(model, _np(params))
    return model


def _t_args(inp):
    return [torch.from_numpy(np.array(v)) for v in _jax_args(inp)]


def _reading(model, jgrads, prefix=""):
    """max over the trainable leaves (named ``prefix``...) of max|port - JAX|
    / max|JAX| (the worst leaf's error as a share of its largest |grad|),
    and the leaves compared. The leaves whose gradient is zero in exact
    arithmetic (``ZERO_GRAD_LEAVES``) are held to ZERO_GRAD_ABS of the
    largest |grad| of all instead."""
    names = {id(p): n for n, p in model.named_parameters()}
    pairs = [(names[id(p)], p, want) for p, want in t_ckpt._pairs(model, jgrads)
             if isinstance(p, torch.nn.Parameter) and p.requires_grad
             and names[id(p)].startswith(prefix)]
    top = max(np.abs(want).max() for _, _, want in pairs)
    worst = 0.0
    for name, param, want in pairs:
        got = np.zeros(want.shape, np.float32) if param.grad is None else param.grad.numpy()
        err = np.abs(got - want).max()
        if ZERO_GRAD_LEAVES.search(name):
            assert max(np.abs(want).max(), np.abs(got).max()) <= ZERO_GRAD_ABS * top, name
        else:  # a leaf JAX gives no gradient (nothing reads it) against the largest
            worst = max(worst, err / (np.abs(want).max() or top))
    return worst, len(pairs)


def _port_grads(kind, mask_fn):
    model = _port(kind)
    apply_mask(model, mask_fn(model))
    _, _, _, inp = _case(kind)
    loss = model.flow_loss(*_t_args(inp))
    loss.backward()
    return model, float(loss)


@pytest.mark.parametrize("kind", ["fp", "lora"])
def test_flow_loss_matches_jax(kind):
    want, _ = _jax_loss_and_grads(kind)
    model = _port(kind)
    _, _, _, inp = _case(kind)
    with torch.no_grad():
        got = float(model.flow_loss(*_t_args(inp)))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    # psi_t and flow_loss against a direct formula
    x, x1, t = torch.randn(2, 4, 7), torch.randn(2, 4, 7), torch.rand(2)
    sig = model.spec.flow_sig_min
    torch.testing.assert_close(model.psi_t(x, x1, t),
                               (1 - (1 - sig) * t[:, None, None]) * x + t[:, None, None] * x1)


@pytest.mark.parametrize("scope", ["all", "action_expert", "vlm"])
def test_scope_gradients_match_jax(scope):
    """Full fine-tuning: each scope's trainable gradients against JAX's
    gradient of the canonical tree (the action leaves sum the proprio
    mixture's contribution). Frozen parameters get no gradient at all."""
    _, jgrads = _jax_loss_and_grads("fp")
    model, _ = _port_grads("fp", SCOPES[scope])
    reading, n = _reading(model, jgrads)
    print(f"scope {scope}: {n} leaves, reading {reading:.3e}")
    assert n > 0 and reading < GRAD_REL_TOL
    frozen = [p for p in model.parameters() if not p.requires_grad]
    assert all(p.grad is None for p in frozen)
    assert (len(frozen) > 0) == (scope != "all")


@pytest.mark.parametrize("base, prefix", [("fp", "vision_tower."), ("w8a8", "joint.vlm."),
                                          ("w4a8", "joint.action.")])
def test_lora_gradients_match_jax(base, prefix):
    """Only the adapters train (lora_trainable_mask): LoRA over fp SigLIP
    weights, QLoRA over the w8a8 vlm and w4a8 action mixtures, whose
    gradients go through the straight-through products and the clip."""
    kind = "lora"
    _, jgrads = _jax_loss_and_grads(kind)
    model, _ = _port_grads(kind, t_lora.lora_trainable_mask)
    reading, n = _reading(model, jgrads, prefix)
    print(f"{base} base: {n} adapter leaves, reading {reading:.3e}")
    assert n > 0 and reading < GRAD_REL_TOL
    assert all(name.endswith(("lora_a", "lora_b"))
               for name, p in model.named_parameters() if p.requires_grad)


def _clip_on_adapter_too(self, x, activation_clip=None):
    if activation_clip is not None:
        x = x.clamp(-activation_clip, activation_clip)
    y = tq.linear(self.base, x, activation_clip)
    return y + ((x @ self.lora_a) @ self.lora_b) * self.lora_s


def test_gradient_bound_separates_planted_faults(monkeypatch):
    kind = "lora"
    _, jgrads = _jax_loss_and_grads(kind)
    sound, _ = _reading(_port_grads(kind, t_lora.lora_trainable_mask)[0], jgrads)
    with monkeypatch.context() as m:
        m.setattr(t_lora.LoRALinear, "forward", _clip_on_adapter_too)
        clip_fault, _ = _reading(_port_grads(kind, t_lora.lora_trainable_mask)[0], jgrads)
    real = t_joint.naive_layers

    def untied(mixtures, *args, **kwargs):  # the proprio mixture's own copy
        mixtures = dict(mixtures)
        mixtures["proprio"] = copy.deepcopy(mixtures["action"])
        return real(mixtures, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(t_joint, "naive_layers", untied)
        tie_fault, _ = _reading(_port_grads(kind, t_lora.lora_trainable_mask)[0], jgrads)
    print(f"sound {sound:.3e}, clip on the adapter {clip_fault:.3e}, "
          f"proprio gradient dropped {tie_fault:.3e} (bound {GRAD_REL_TOL:g})")
    assert sound < GRAD_REL_TOL < min(clip_fault, tie_fault)


def test_straight_through_backward_matches_jax():
    """w8a8_mm / w4a8_mm differentiate as JAX's custom VJPs: g @ deq(W)^T,
    zero past the clip (the clip stays outside the Function)."""
    rng = np.random.RandomState(0)
    w = rng.randn(64, 24).astype(np.float32) * 0.1
    x = rng.randn(3, 64).astype(np.float32)
    g = rng.randn(3, 24).astype(np.float32)
    for quantize, j_mm, t_mm in ((jq.quantize_weight_w8a8, jq.w8a8_mm, tq.w8a8_mm),
                                 (jq.quantize_weight_w4a8, jq.w4a8_mm, tq.w4a8_mm)):
        jw = jax.jit(quantize)(jnp.asarray(w))
        tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
        _, vjp = jax.vjp(lambda a: j_mm(a, jw, CLIP), jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        tx = torch.from_numpy(x).requires_grad_()
        t_mm(tx, tw, CLIP).backward(torch.from_numpy(g))
        np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5, atol=1e-6)
        assert (tx.grad.numpy()[np.abs(x) > CLIP] == 0).all()
        assert np.abs(want).max() > 0


def test_remat_same_gradients_and_int4_calls_twice(monkeypatch):
    """``remat`` recomputes each layer in the backward: the same gradients,
    and every w4a8 product runs twice a step. Per step: 7 products a layer
    and mixture, less the 4 the vlm and proprio mixtures skip in the last
    layer (the full width's 370 in miniature)."""
    calls = []
    real = tq.int4_matmul

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tq, "int4_matmul", counting)
    kind = "lora"
    _, _, _, inp = _case(kind)
    grads = []
    for remat in (False, True):
        model = _port(kind)
        apply_mask(model, t_lora.lora_trainable_mask(model))
        calls.clear()
        model.flow_loss(*_t_args(inp), remat=remat).backward()
        layers = model.joint_spec.num_hidden_layers
        # the action mixture (and the tied proprio) is the w4a8 one
        assert len(calls) == (1 + remat) * (2 * 7 * layers - 4)
        grads.append([p.grad for p in model.parameters() if p.requires_grad])
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*grads))


def test_flash_attention_refuses_gradients():
    """K1 has no backward: with use_flash_attn set, a loss that needs a
    gradient raises; without gradients it runs."""
    cfg = tiny_pi0_cfg(max_image_text_tokens=72, max_seq_len=72)
    cfg.joint.config.head_dim = 32
    cfg.joint.config.use_flash_attn = True
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    inp = tiny_inputs(cfg)
    args = [torch.from_numpy(np.array(inp[k])) for k in
            ("input_ids", "attention_mask", "pixel_values", "proprios", "noise")]
    args += [torch.rand(2), torch.randn(2, 4, 7)]
    with pytest.raises(RuntimeError, match="no backward"):
        model.flow_loss(*args)
    with torch.no_grad():
        assert torch.isfinite(model.flow_loss(*args))


def test_schedules_exact():
    """optax's warmup_cosine_decay_schedule (what the JAX trainer steps)
    and cosine_annealing_warmup_restarts (what it logs), at every step of
    short runs, equal to the bit."""
    import optax

    for lr, total, warmup in ((1e-4, 7, 3), (3e-4, 10, 1), (1e-3, 4, 0)):
        kw = dict(init_value=lr * 0.01, peak_value=lr, warmup_steps=warmup,
                  decay_steps=total, end_value=lr * 0.01)
        want = optax.warmup_cosine_decay_schedule(**kw)
        got = t_optim.warmup_cosine_decay_schedule(**kw)
        if warmup:  # step 0 is init_value, as optax rounds (init - peak) + peak
            assert got(0) == pytest.approx(lr * 0.01, rel=1e-5)
        for step in range(total + 3):
            assert got(step) == float(np.float32(want(step))), (lr, total, warmup, step)
        cycle = dict(first_cycle_steps=total, max_lr=lr, min_lr=lr * 0.01,
                     warmup_steps=warmup)
        jw, tw = (j_optim.cosine_annealing_warmup_restarts(**cycle),
                  t_optim.cosine_annealing_warmup_restarts(**cycle))
        assert [tw(s) for s in range(2 * total)] == [jw(s) for s in range(2 * total)]


def test_optimizer_steps_match_jax():
    """Three optimizer steps of the port's train step against JAX's
    make_optax_train_step with MultiSteps(chain(masked_freeze(chain(
    clip_by_global_norm, adamw(schedule)), mask), params_ema(mask)), 2):
    scope action_expert, accumulation 2 (6 micro-steps), clip 0.05 (it
    bites), EMA 0.9. Both take the same noise and t: JAX's own draws from
    each step's key, handed to the port. After each update the trainable
    parameters agree within 1e-6 + 1e-4 relative (Adam divides each moment
    by its own root, so gradient rounding moves an update by up to its
    learning-rate scale where a gradient is near zero); the frozen ones are
    bit-unchanged; the EMA agrees at the end."""
    import optax

    from blurr_tpu.models.pi0.trainable import action_expert_mask
    from blurr_tpu.parallel.train import make_optax_train_step

    cfg, jm, params, inp = _case("fp")
    lr, steps, k = 1e-3, 6, 2
    sched_kw = dict(init_value=lr * 0.01, peak_value=lr, warmup_steps=1, decay_steps=3,
                    end_value=lr * 0.01)
    mask = action_expert_mask(params)
    inner = optax.chain(optax.clip_by_global_norm(0.05),
                        optax.adamw(optax.warmup_cosine_decay_schedule(**sched_kw)))
    tx = optax.MultiSteps(optax.chain(j_optim.masked_freeze(inner, mask),
                                      j_optim.params_ema(0.9, mask=mask)), k)
    j_step = make_optax_train_step(jm, tx)
    j_params, j_state = params, tx.init(params)

    model = _port("fp")
    trainable = apply_mask(model, SCOPES["action_expert"](model))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    opt = t_optim.AdamW(trainable, t_optim.warmup_cosine_decay_schedule(**sched_kw),
                        grad_clip=0.05)
    ema = t_optim.ParamsEMA(trainable, 0.9)
    step = make_train_step(model, opt, accum_steps=k, ema=ema)
    batch = {key: inp[key] for key in
             ("input_ids", "attention_mask", "pixel_values", "proprios", "actions")}
    t_batch = {key: torch.from_numpy(np.array(v)) for key, v in batch.items()}
    key = jax.random.PRNGKey(5)
    for i in range(steps):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)  # make_optax_train_step's own draws
        noise = np.asarray(jax.random.normal(k1, batch["actions"].shape, jnp.float32))
        t = np.asarray(jax.random.beta(k2, 1.5, 1.0, (batch["actions"].shape[0],)))
        j_params, j_state, j_loss = j_step(j_params, j_state, batch, sub)
        loss = step(t_batch, torch.from_numpy(noise), torch.from_numpy(t))
        assert abs(float(loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
        if (i + 1) % k:
            continue
        assert opt.count == (i + 1) // k
        for param, want in t_ckpt._pairs(model, _np(j_params)):
            if isinstance(param, torch.nn.Parameter) and param.requires_grad:
                np.testing.assert_allclose(param.detach().numpy(), want, rtol=1e-4,
                                           atol=1e-6)
    assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters()
               if not p.requires_grad)
    j_ema = _np(j_optim.extract_ema(j_state, j_params))
    values = t_optim.extract_ema(ema, model)
    names = {id(p): n for n, p in model.named_parameters()}
    for param, want in t_ckpt._pairs(model, j_ema):
        if isinstance(param, torch.nn.Parameter) and param.requires_grad:
            np.testing.assert_allclose(values[names[id(param)]].numpy(), want,
                                       rtol=1e-4, atol=1e-6)


def test_sample_noise_and_t():
    """t ~ Beta(1.5, 1) as u ** (2/3): its mean 0.6 and CDF t ** 1.5."""
    g = torch.Generator().manual_seed(0)
    noise, t = sample_noise_and_t(g, torch.zeros(20000, 4, 7))
    assert noise.shape == (20000, 4, 7) and noise.dtype == torch.float32
    assert abs(float(t.mean()) - 0.6) < 0.01 and float(t.min()) >= 0 and float(t.max()) <= 1
    assert abs(float((t < 0.5).float().mean()) - 0.5 ** 1.5) < 0.01


def test_bf16_cast_keeps_scales_fp32():
    """cast_floating_preserving_scales: weights and adapters bf16, the quant
    payloads and scales and lora_s as they were (JAX's rule)."""
    model = _port("lora")
    t_optim.cast_floating_preserving_scales(model, torch.bfloat16)
    q = model.joint["action"].layers[0].q_proj
    assert isinstance(q, t_lora.LoRALinear) and isinstance(q.base, tq.W4A8Linear)
    assert q.lora_a.dtype == q.lora_b.dtype == torch.bfloat16
    assert q.lora_s.dtype == q.base.s.dtype == torch.float32 and q.base.q4.dtype == torch.int8
    assert model.embed_tokens.dtype == torch.bfloat16
    n = sum(t.numel() for t in (*model.parameters(), *model.buffers()))
    assert t_optim.get_num_params_in_billions(model) == n / 1e9
    cast = t_optim.cast_params(_port("lora"), torch.bfloat16)
    assert cast["joint.action.layers.0.q_proj.lora_a"].dtype == torch.bfloat16
    assert cast["joint.action.layers.0.q_proj.base.s"].dtype == torch.float32
    assert "joint.proprio.layers.0.q_proj.lora_a" not in cast  # the tie, once
