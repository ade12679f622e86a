"""Data-parallel, tensor-parallel and FSDP training of the port on spawned
``gloo`` ranks (one process each, rendezvous through a ``FileStore``),
against the JAX package's single-device step on the CPU.

Two spawns, one per world size, in module-scoped fixtures whose results
the cases read: two ranks run every case at dp=2, tp=2 and dp=2 with FSDP
(and the planted faults), four ranks at 2x2 and 2x2 with FSDP. The models
are tiny and fp32, with JAX's weights carried across by
``load_jax_params``. The bound is JAX's own for meshed against
single-device (``tests/test_parallel.py``): ``rtol=5e-4, atol=5e-5``.

- Pi-0, full fine-tuning: the gradients one step hands the optimizer
  (every parameter trainable, gathered into the one-card tree) against
  JAX's gradients of the same loss.
- Pi-0, JAX's ``dryrun_multichip`` section 1 and
  ``test_fsdp_train_step_matches_single_device``: the masked AdamW step
  (scope action_expert, clip 0.05, which bites, and EMA 0.9), two steps
  on JAX's own noise and flow-time draws: the losses, the clip's global
  norm at each step, the trainable parameters and the EMA after them.
- Pi-0 QLoRA w4a8 (both mixtures w4a8, adapters on SigLIP and both
  mixtures, activation clip 0.5) at tp=2: the adapters' gradients against
  JAX's, whose w4a8 products run its Pallas kernel in interpret mode.
- OpenVLA QLoRA w8a8 at 2x2 (``dryrun_multichip`` section 6): the
  ``action_ce_loss`` of one step against JAX's.
- ``fsdp_dim`` against JAX's ``pi0_param_sharding(fsdp=True)``, tensor
  for tensor, at dp=2 and at 2x2; the FSDP rank's parameter and moment
  bytes against the plain data-parallel rank's (JAX's
  ``test_fsdp_reduces_per_device_state_bytes``).
- Planted faults, each planted in the ranks, each of which must read
  outside the bound: a ``copy_to_group`` whose backward skips its
  all-reduce (tp=2 gradients), a data-parallel step that sums the ranks'
  gradients instead of averaging them (dp=2 gradients), and a clip norm
  that counts every leaf as split over the model ranks, so a replicated
  one counts tp times (tp=2 norms).
"""

import functools
import json
import pickle
import time

import numpy as np
import pytest
import torch

from blurr_tpu_torch.models.openvla import llama as t_llama
from blurr_tpu_torch.models.openvla import model as t_vla
from blurr_tpu_torch.models.openvla.checkpoint import load_jax_params as load_vla_params
from blurr_tpu_torch.models.pi0 import checkpoint as t_ckpt
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.trainable import SCOPES, apply_mask
from blurr_tpu_torch.ops import lora as t_lora
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.parallel import fsdp as t_fsdp
from blurr_tpu_torch.parallel import mesh as t_mesh
from blurr_tpu_torch.parallel import train as t_train
from blurr_tpu_torch.utils import optim as t_optim

JAX_RTOL, JAX_ATOL = 5e-4, 5e-5  # tests/test_parallel.py
SPAWN_DEADLINE_S = 600.0
LR, CLIP, EMA_DECAY, STEPS = 1e-3, 0.05, 0.9, 2
SCHEDULE = dict(init_value=LR * 0.01, peak_value=LR, warmup_steps=1, decay_steps=3,
                end_value=LR * 0.01)
# the FSDP rank's parameter and moment bytes against the data-parallel rank's
FSDP_BYTES_MAX = 0.55
# (data, model, fsdp) of each mesh, by the world it runs in
MESHES = {2: {"dp2": (2, 1, False), "tp2": (1, 2, False), "dp2_fsdp": (2, 1, True)},
          4: {"2x2": (2, 2, False), "2x2_fsdp": (2, 2, True)}}
QLORA_TARGETS = ("q_w", "v_w", "fc1_w", "gate_w", "down_w")
QLORA_RANK, QLORA_CLIP, B_SCALE = 2, 0.5, 0.05
ZERO_GRAD = "k_proj.bias"  # SigLIP's key bias: its gradient is rounding noise


def _plain(cfg):
    """A plain-dict copy of a config (the ranks unpickle no JAX class)."""
    return json.loads(json.dumps(cfg))


# ---------------------------------------------------------------------------
# The ranks (these run in the spawned processes, without JAX)
# ---------------------------------------------------------------------------


class _Recording(t_optim.AdamW):
    """An optimizer that records the gradients it is handed and does not
    step."""

    def step(self, grads):
        self.seen = [torch.zeros_like(p) if g is None else g.detach().clone()
                     for p, g in zip(self.params, grads)]


def _pi0(payload, kind):
    model = PiZero(payload["cfg"][kind], device="cpu", dtype=torch.float32)
    if kind == "qlora":
        g = torch.Generator().manual_seed(0)
        t_lora.inject_lora_tree(model.vision_tower, g, QLORA_RANK, QLORA_TARGETS)
        for m in ("vlm", "action"):
            tq.quantize_mixture_w4a8(model.joint[m].layers)
            t_lora.inject_lora_tree(model.joint[m], g, QLORA_RANK, QLORA_TARGETS)
    t_ckpt.load_jax_params(model, payload["tree"][kind])
    return model


def _openvla(payload):
    model = t_vla.OpenVLA(t_vla.OpenVLASpec.tiny(), device="cpu", dtype=torch.float32)
    t_llama.quantize_llama_w8a8(model.llama)
    t_lora.inject_lora_tree(model.llama, torch.Generator().manual_seed(0), *payload["vla_lora"])
    load_vla_params(model, payload["vla_tree"])
    return model


def _shard(model, mesh, fsdp):
    t_mesh.shard_params(model, mesh)
    if fsdp:
        t_fsdp.shard_fsdp(model, mesh)
    return model


def _gather(model, mesh, tensors):
    """{one-card name: numpy} of ``tensors`` ({sharded name: tensor})."""
    where = t_fsdp.layout(model, mesh)
    return {where[n].name: t_fsdp.gather_tensor(t, where[n], mesh).numpy()
            for n, t in tensors.items()}


def _handed_grads(model, mesh, trainable, batch, extra, keys=t_train._BATCH_KEYS,
                  loss_fn=t_train.flow_loss):
    """(loss, {one-card name: the gradient one step hands the optimizer})."""
    opt = _Recording(trainable, lambda c: 0.0)
    step = t_train.make_train_step(model, opt, mesh=mesh, loss_fn=loss_fn, batch_keys=keys)
    loss = float(step(batch, *extra))
    names = {id(p): n for n, p in model.named_parameters()}
    return loss, _gather(model, mesh, {names[id(p)]: g for p, g in zip(trainable, opt.seen)})


def _pi0_grads(payload, mesh, fsdp):
    model = _shard(_pi0(payload, "fp"), mesh, fsdp)
    trainable = apply_mask(model, SCOPES["all"](model))
    return _handed_grads(model, mesh, trainable, payload["batch"], payload["extra"])


def _qlora_grads(payload, mesh):
    model = _shard(_pi0(payload, "qlora"), mesh, False)
    trainable = apply_mask(model, t_lora.lora_trainable_mask(model))
    return _handed_grads(model, mesh, trainable, payload["batch"], payload["extra"])


def _vla_loss(payload, mesh):
    model = _shard(_openvla(payload), mesh, False)
    trainable = apply_mask(model, t_lora.lora_trainable_mask(model))
    keys = ("input_ids", "attn_valid", "pixel_values", "labels")

    def ce(m, ids, valid, px, labels, remat=False):
        return m.action_ce_loss(ids, valid, px, labels, remat=remat)

    return _handed_grads(model, mesh, trainable, payload["vla_batch"], (), keys, ce)[0]


def _pi0_adam(payload, mesh, fsdp, count_tp_times=False):
    """Two masked AdamW steps: losses, clip norms, gathered trainable
    parameters and EMA, and this rank's parameter and moment bytes."""
    model = _shard(_pi0(payload, "fp"), mesh, fsdp)
    trainable = apply_mask(model, SCOPES["action_expert"](model))
    split = t_fsdp.split_axes(model, trainable, mesh)
    if count_tp_times:  # the planted fault: every leaf summed over the model ranks
        split = [(True, data) for _, data in split]
    opt = t_optim.AdamW(trainable, t_optim.warmup_cosine_decay_schedule(**SCHEDULE),
                        grad_clip=CLIP, mesh=mesh, split=split)
    ema = t_optim.ParamsEMA(trainable, EMA_DECAY)
    step = t_train.make_train_step(model, opt, ema=ema, mesh=mesh)
    norms, losses = [], []
    real = t_optim._global_norm

    def norm(*args):
        out = real(*args)
        norms.append(float(out))
        return out

    t_optim._global_norm = norm
    try:
        for noise, t in payload["draws"]:
            losses.append(float(step(payload["batch"], torch.from_numpy(noise),
                                     torch.from_numpy(t))))
    finally:
        t_optim._global_norm = real
    names = {id(p): n for n, p in model.named_parameters()}
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*model.parameters(), *model.buffers(), *opt.mu, *opt.nu))
    return {"losses": losses, "norms": norms, "bytes": nbytes,
            "params": _gather(model, mesh, {names[id(p)]: p for p in trainable}),
            "ema": _gather(model, mesh, {names[id(p)]: e for p, e in zip(trainable, ema.ema)})}


def _planted(target, attr, value, fn):
    real = getattr(target, attr)
    setattr(target, attr, value)
    try:
        return fn()
    finally:
        setattr(target, attr, real)


def _copy_without_all_reduce(ctx, g):
    return g, None


def _summing(real):
    def average_over_data(grads, params, summed, mesh):  # the sum, not the mean
        return [g * mesh.data for g in real(grads, params, summed, mesh)]
    return average_over_data


def _job(world, payload, meshes):
    out = {}
    for name, mesh in meshes.items():
        _, _, fsdp = MESHES[world][name]
        out[name] = {"grads": _pi0_grads(payload, mesh, fsdp),
                     "adam": _pi0_adam(payload, mesh, fsdp)}
    if world == 2:
        tp2, dp2 = meshes["tp2"], meshes["dp2"]
        out["qlora_tp2"] = _qlora_grads(payload, tp2)
        out["fault_copy"] = _planted(t_mesh._Copy, "backward",
                                     staticmethod(_copy_without_all_reduce),
                                     lambda: _pi0_grads(payload, tp2, False))
        out["fault_dp_sum"] = _planted(t_train, "average_over_data",
                                       _summing(t_train.average_over_data),
                                       lambda: _pi0_grads(payload, dp2, False))
        out["fault_clip"] = _pi0_adam(payload, tp2, False, count_tp_times=True)
    else:
        out["vla_2x2"] = _vla_loss(payload, meshes["2x2"])
        model = _pi0(payload, "fp")
        mesh = meshes["2x2_fsdp"]
        t_mesh.shard_params(model, mesh)
        where = t_fsdp.layout(model, mesh)
        out["plan_2x2"] = {where[n].name: d for n, d in t_fsdp.fsdp_plan(model, mesh).items()}
    return out


def _rank(rank, world, init_method, payload_path, queue):
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        payload["batch"] = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
        payload["extra"] = tuple(torch.from_numpy(v) for v in payload["extra"])
        payload["vla_batch"] = {k: torch.from_numpy(v) for k, v in payload["vla_batch"].items()}
        t_mesh.init_ranks(rank, world, init_method, "cpu")
        meshes = {name: t_mesh.make_mesh(data, model)
                  for name, (data, model, _) in MESHES[world].items()}
        out = _job(world, payload, meshes)
        torch.distributed.destroy_process_group()
        queue.put((rank, out if rank == 0 else {"bytes": {
            n: r["adam"]["bytes"] for n, r in out.items() if isinstance(r, dict) and "adam" in r}}))
    except BaseException as exc:  # the parent raises it
        queue.put((rank, exc))
        raise


def _start(world, tmp, payload):
    """Start ``world`` spawned ranks on ``payload`` (through a file: a large
    one written to each child's pipe would start the children one by
    one); ``_collect`` reads their results."""
    import multiprocessing as mp

    path = tmp / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, f"file://{tmp}/store", str(path), q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return world, procs, q, time.monotonic() + SPAWN_DEADLINE_S


def _collect(started):
    """{rank: result} of ``_start``'s ranks, joined by the deadline."""
    import queue as queue_lib

    world, procs, q, deadline = started
    results = {}
    try:
        while len(results) < world:
            try:
                rank, out = q.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue_lib.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(results))} did "
                                   f"not answer within {SPAWN_DEADLINE_S} s")
            if isinstance(out, BaseException):
                raise RuntimeError(f"rank {rank} failed") from out
            results[rank] = out
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
    return results


# ---------------------------------------------------------------------------
# JAX's references and the fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _qlora_case():
    """JAX's QLoRA w4a8 tree (both mixtures w4a8, adapters on SigLIP and
    both mixtures, B drawn non-zero) and its config."""
    import jax
    import jax.numpy as jnp

    from blurr_tpu.ops import lora as j_lora
    from blurr_tpu.ops import quant as jq
    from tests.test_torch_train import _case
    from tests.util import tiny_pi0_cfg

    cfg = tiny_pi0_cfg()
    for m in ("vlm", "action"):
        cfg[f"{m}_quantization"] = {"mode": "w4a8", "activation_clip": QLORA_CLIP}
    params = dict(_case("fp")[2])
    params["joint"] = dict(params["joint"])
    rng = jax.random.PRNGKey(7)
    inject = jax.jit(lambda t: j_lora.inject_lora_tree(t, rng, QLORA_RANK, QLORA_TARGETS))
    params["siglip"] = inject(params["siglip"])
    for m in ("vlm", "action"):
        params["joint"][m] = inject(jax.jit(jq.quantize_mixture_w4a8)(params["joint"][m]))
    b_rng = np.random.RandomState(3)

    def nonzero_b(t):
        if j_lora.is_lora_dict(t):
            return {**t, "lora_b": jnp.asarray(
                b_rng.randn(*t["lora_b"].shape).astype(np.float32) * B_SCALE)}
        if isinstance(t, dict):
            return {k: nonzero_b(v) for k, v in t.items()}
        return t

    return cfg, nonzero_b(params)


@pytest.fixture(scope="module")
def payload():
    """The ranks' payload: JAX's trees, the batch, the step's (x0, t) and
    two steps' draws of JAX's own step (from its keys, which ``refs``
    replays)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_openvla_train import ALPHA, RANK, TARGETS
    from tests.test_torch_openvla_train import _case as vla_case
    from tests.test_torch_train import _case

    cfg, _, params, inp = _case("fp")
    batch = {k: np.asarray(inp[k]) for k in t_train._BATCH_KEYS}
    key, keys, draws = jax.random.PRNGKey(5), [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)  # make_optax_train_step's own draws
        keys.append(sub)
        draws.append((np.asarray(jax.random.normal(k1, batch["actions"].shape, jnp.float32)),
                      np.asarray(jax.random.beta(k2, 1.5, 1.0, (batch["actions"].shape[0],)))))
    q_cfg, q_params = _qlora_case()
    _, vla_params, vla_inp = vla_case("tiny", "ar", "w8a8")
    return {
        "cfg": {"fp": _plain(cfg), "qlora": _plain(q_cfg)},
        "tree": {"fp": _np(params), "qlora": _np(q_params)},
        "batch": batch, "extra": (np.asarray(inp["x0"]), np.asarray(inp["t"])),
        "draws": draws, "keys": keys, "vla_tree": vla_params,
        "vla_lora": (RANK, TARGETS, ALPHA),
        "vla_batch": {"input_ids": vla_inp["ids"], "attn_valid": vla_inp["valid"],
                      "pixel_values": vla_inp["px"], "labels": np.asarray(vla_inp["labels"])},
    }


@pytest.fixture(scope="module")
def started(payload, tmp_path_factory):
    """Both spawns started (they run while ``refs`` computes JAX's side)."""
    ranks_payload = {k: v for k, v in payload.items() if k != "keys"}
    return {world: _start(world, tmp_path_factory.mktemp(f"world{world}"), ranks_payload)
            for world in MESHES}


@pytest.fixture(scope="module")
def refs(payload, started):
    """JAX's single-device references."""
    import jax
    import jax.numpy as jnp
    import optax

    from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
    from blurr_tpu.models.pi0.trainable import action_expert_mask
    from blurr_tpu.parallel.train import make_optax_train_step
    from blurr_tpu.utils import optim as j_optim
    from tests.test_torch_openvla_train import _jax_loss_and_grads as vla_loss_and_grads
    from tests.test_torch_train import _case, _jax_args, _jax_loss_and_grads

    _, jm, params, inp = _case("fp")
    out = {"fp_grads": _jax_loss_and_grads("fp")}
    batch = payload["batch"]

    # two masked AdamW steps (clip, EMA) on JAX's own draws, and the clip's
    # norm at each: optax's global norm of the trainable gradients
    mask = action_expert_mask(params)
    inner = optax.chain(optax.clip_by_global_norm(CLIP),
                        optax.adamw(optax.warmup_cosine_decay_schedule(**SCHEDULE)))
    tx = optax.chain(j_optim.masked_freeze(inner, mask), j_optim.params_ema(EMA_DECAY, mask=mask))
    j_step = make_optax_train_step(jm, tx)
    grad_fn = jax.jit(jax.grad(lambda p, n, t: jm.flow_loss(
        p, *[batch[k] for k in t_train._BATCH_KEYS], t, n)))
    p, state = params, tx.init(params)
    losses, norms = [], []
    for sub, (noise, t) in zip(payload["keys"], payload["draws"]):
        g = grad_fn(p, noise, t)
        norms.append(float(optax.global_norm(jax.tree.map(
            lambda a, m: a if m else jnp.zeros_like(a), g, mask))))
        p, state, loss = j_step(p, state, batch, sub)
        losses.append(float(loss))
    out["adam"] = {"losses": losses, "norms": norms, "params": _np(p),
                   "ema": _np(j_optim.extract_ema(state, p))}

    # QLoRA w4a8: JAX's w4a8 products through its Pallas kernel (interpret)
    q_cfg, q_params = _qlora_case()
    args = _jax_args(inp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BLURR_INT4_FORCE", "interpret")
        fn = j_optim.value_and_grad_frozen_int(lambda q: JPiZero(q_cfg).flow_loss(q, *args))
        _, q_grads = jax.jit(fn)(q_params)
    out["qlora_grads"] = _np(q_grads)
    out["vla_loss"] = vla_loss_and_grads("tiny", "ar", "w8a8")[0]
    return out


@pytest.fixture(scope="module")
def two(started, refs):
    return _collect(started[2])


@pytest.fixture(scope="module")
def four(started, refs):
    return _collect(started[4])


def _one_card(kind):
    """The one-card port model of a case (for the JAX leaf -> name map)."""
    from tests.test_torch_train import _case

    cfg = _case("fp")[0] if kind == "fp" else _qlora_case()[0]
    payload = {"cfg": {kind: _plain(cfg)},
               "tree": {kind: _np(_case("fp")[2] if kind == "fp" else _qlora_case()[1])}}
    return _pi0(payload, kind)


def _pairs(kind, tree):
    """[(one-card name, JAX's array)] of every parameter the tree has."""
    model = _one_card(kind)
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], want) for p, want in t_ckpt._pairs(model, tree)
            if isinstance(p, torch.nn.Parameter)]


def _worst(got, pairs, skip=()):
    """The worst leaf's max |port - JAX| over JAX's bound (atol + rtol |JAX|),
    over the leaves ``got`` names; >1 is outside it."""
    worst, n = 0.0, 0
    for name, want in pairs:
        if name not in got or any(s in name for s in skip):
            continue
        bound = JAX_ATOL + JAX_RTOL * np.abs(want)
        worst = max(worst, float((np.abs(got[name] - want) / bound).max()))
        n += 1
    return worst, n


def _result(two, four, name):
    return (two[0] if name in MESHES[2] else four[0])[name]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

ALL_MESHES = [*MESHES[2], *MESHES[4]]


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_full_fine_tuning_gradients_match_jax(two, four, refs, mesh):
    loss, grads = _result(two, four, mesh)["grads"]
    want_loss, jgrads = refs["fp_grads"]
    np.testing.assert_allclose(loss, want_loss, rtol=JAX_RTOL, atol=JAX_ATOL)
    worst, n = _worst(grads, _pairs("fp", jgrads))
    print(f"{mesh}: {n} gradient leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(grads) and worst <= 1.0


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_masked_adamw_steps_match_jax(two, four, refs, mesh):
    got, want = _result(two, four, mesh)["adam"], refs["adam"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=JAX_RTOL)
    assert min(want["norms"]) > CLIP  # the clip bites
    for key in ("params", "ema"):
        worst, n = _worst(got[key], _pairs("fp", want[key]))
        print(f"{mesh} {key}: {n} trainable leaves after {STEPS} steps, worst {worst:.3f}")
        assert n == len(got[key]) and worst <= 1.0


def test_qlora_w4a8_tp2_gradients_match_jax_pallas(two, refs):
    _, grads = two[0]["qlora_tp2"]
    assert grads and all(n.endswith(("lora_a", "lora_b")) for n in grads)
    worst, n = _worst(grads, _pairs("qlora", refs["qlora_grads"]))
    print(f"QLoRA w4a8 tp=2: {n} adapter leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(grads) and worst <= 1.0


def test_openvla_qlora_w8a8_2x2_loss_matches_jax(four, refs):
    np.testing.assert_allclose(four[0]["vla_2x2"], refs["vla_loss"], rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_planted_faults_read_outside_the_bound(two, refs):
    want_loss, jgrads = refs["fp_grads"]
    pairs = _pairs("fp", jgrads)
    copy_fault, _ = _worst(two[0]["fault_copy"][1], pairs, skip=(ZERO_GRAD,))
    sum_fault, _ = _worst(two[0]["fault_dp_sum"][1], pairs, skip=(ZERO_GRAD,))
    norms = np.asarray(two[0]["fault_clip"]["norms"])
    clip_fault = float((np.abs(norms - refs["adam"]["norms"])
                        / (JAX_RTOL * np.abs(refs["adam"]["norms"]))).max())
    sound, _ = _worst(two[0]["tp2"]["grads"][1], pairs)
    print(f"sound tp2 {sound:.3f}; copy without its all-reduce {copy_fault:.3g}, the "
          f"ranks' gradients summed {sum_fault:.3g}, a replicated leaf counted tp times in "
          f"the clip's norm {clip_fault:.3g} (of JAX's bound)")
    assert sound <= 1.0 < min(copy_fault, sum_fault, clip_fault)


def _jax_fsdp_axes(data, model):
    """{one-card name: the port axis JAX shards over 'data', or None} of the
    tiny fp tree under ``pi0_param_sharding(fsdp=True)``: each JAX leaf is
    replaced by an array that counts along its 'data' axis, and
    ``load_jax_params``'s own map (unstacking, transposing) says where that
    axis lands in the port (a constant: JAX's stacked layer axis, which the
    port has not)."""
    import jax

    from blurr_tpu.parallel.mesh import make_mesh, pi0_param_sharding
    from tests.test_torch_train import _case

    params = _case("fp")[2]
    shardings = pi0_param_sharding(params, make_mesh(data=data, model=model), fsdp=True)

    def marker(a, s):
        spec = tuple(s.spec) + (None,) * (np.ndim(a) - len(s.spec))
        m = np.zeros(np.shape(a), np.float32)
        if "data" in spec:
            d = spec.index("data")
            shape = [1] * m.ndim
            shape[d] = m.shape[d]
            m = m + np.arange(m.shape[d], dtype=np.float32).reshape(shape)
        return m

    marked = jax.tree.map(marker, _np(params), shardings)
    out = {}
    for name, m in _pairs("fp", marked):
        varying = [d for d in range(m.ndim) if m.shape[d] > 1 and np.ptp(m, axis=d).max() > 0]
        out[name] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("mesh", ["dp2", "2x2"])
def test_fsdp_dim_matches_jax_leaf_for_leaf(four, mesh):
    data, model = MESHES[2]["dp2"][:2] if mesh == "dp2" else MESHES[4]["2x2"][:2]
    if mesh == "dp2":  # no process group needed: the plan of a one-card model
        port = _one_card("fp")
        plan = t_fsdp.fsdp_plan(port, t_mesh.Mesh(data=2))
    else:
        plan = four[0]["plan_2x2"]
    want = _jax_fsdp_axes(data, model)
    assert want.keys() >= plan.keys() and any(v is not None for v in want.values())
    cut = 0
    for name, axis in want.items():
        if model > 1 and name.endswith(".bias") and t_mesh.rule_for(name[:-5]) == t_mesh.COLUMN:
            # the port cuts a column layer's bias with its output (JAX keeps
            # biases whole and slices them at the add): no free axis is left
            axis, cut = None, cut + 1
        assert plan.get(name) == axis, (name, plan.get(name), axis)
    assert (cut > 0) == (model > 1)


def test_fsdp_halves_the_rank_state(two):
    plain = [two[r]["bytes"]["dp2"] if r else two[0]["dp2"]["adam"]["bytes"] for r in (0, 1)]
    fsdp = [two[r]["bytes"]["dp2_fsdp"] if r else two[0]["dp2_fsdp"]["adam"]["bytes"]
            for r in (0, 1)]
    ratio = max(f / p for f, p in zip(fsdp, plain))
    print(f"FSDP rank's parameter + moment bytes over plain DP's: {ratio:.3f}")
    assert ratio <= FSDP_BYTES_MAX
