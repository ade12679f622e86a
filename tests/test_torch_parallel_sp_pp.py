"""Sequence- and pipeline-parallel training of the port on spawned ``gloo``
ranks, against the JAX package on the CPU, and the trainer's ``--sp`` /
``--pp`` / ``--pp-microbatches``.

Two spawns, one per world size (2 and 4 ranks, rendezvous through a
``FileStore``), in module fixtures; each rank runs every case of its world
and rank 0 (for a pipeline, every stage: each holds its own layers)
reports. The models are tiny and fp32, with JAX's weights carried across
by ``load_jax_params``; the inputs come from numpy seeds. Each case is held
at JAX's own bound:

- Sequence parallelism (``tests/test_parallel.py:610-708``, dryrun section
  5): ``flow_loss`` and every gradient one step hands the optimizer at
  seq=2 against JAX's unsharded run (loss ``rtol=5e-5``, gradients
  ``rtol=5e-4, atol=5e-5``); the loss at data 2 x seq 2 with remat, data 2
  x seq 2 with FSDP and seq 2 x model 2 (``5e-5``); the token rows each
  rank's SigLIP and vlm layers took (the port's form of
  ``test_sp_compile_shards_sequence_axis``); ``sp`` with ``pipeline``
  raises JAX's ``ValueError``.
- Pipeline parallelism (``tests/test_pipeline.py``, dryrun section 4):
  the GPipe schedule on JAX's toy layer at (stages, data, microbatches) =
  (2, 1, None), (4, 1, None), (2, 1, 4), (2, 2, None), and a batch of 6 on
  4 stages (M = 3), values (``1e-6``) and gradients (``rtol=2e-5,
  atol=1e-6``) against ``lax.scan``, as JAX's ``pipelined_scan`` is held;
  ``flow_loss`` and every gradient at 2 stages with and without remat, at
  4 stages and at data 2 x 2 stages, and with an adaLN expert, against
  JAX's plain scan (loss ``1e-5``, gradients ``rtol=5e-4, atol=1e-5``);
  one masked-AdamW step (``test_pp_train_step_matches_unpipelined``).
- Planted faults, patched in the ranks, each of which must read outside
  its bound: the own-slice gather (``_Gather``'s backward) in the place of
  the sum-backward gather's (sequence parallelism's K/V), the seq ranks'
  losses differentiated whole (a replicated row counted seq times), and a
  pipe group that does not sum the replicated parameters' gradients.
- The trainer (``scripts/train_pi0_flow_torch.py``) at bridge_tiny widths
  as subprocesses: ``--pp 2`` (``bridge_tiny_pp.yaml``), ``--pp 2 --dp 2``
  and ``--sp 2`` (``bridge_tiny.yaml``) for 2 steps against one card within
  JAX's meshed bound (``rtol=5e-4, atol=5e-5``, tighter than the card's
  2e-2), every rank the same losses; a ``--pp 2 --save-state`` run stopped
  after one step, resumed on one card and at ``--pp 2``, ends with the
  one-card run's tree; and JAX's refusals, message for message.
"""

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from blurr_tpu_torch.models.pi0 import checkpoint as t_ckpt
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.trainable import SCOPES, apply_mask
from blurr_tpu_torch.parallel import fsdp as t_fsdp
from blurr_tpu_torch.parallel import mesh as t_mesh
from blurr_tpu_torch.parallel import pipeline as t_pipe
from blurr_tpu_torch.parallel import train as t_train
from blurr_tpu_torch.utils import optim as t_optim

REPO_ROOT = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 300.0
SP_LOSS_RTOL, SP_RTOL, SP_ATOL = 5e-5, 5e-4, 5e-5  # tests/test_parallel.py
PP_LOSS_RTOL, PP_RTOL, PP_ATOL = 1e-5, 5e-4, 1e-5  # tests/test_pipeline.py
TOY_RTOL, TOY_GRAD_RTOL, TOY_GRAD_ATOL = 1e-6, 2e-5, 1e-6
CLI_RTOL, CLI_ATOL = 5e-4, 5e-5  # tests/test_parallel.py's meshed bound
L, B, D = 8, 4, 6  # the toy: JAX's test_pipeline.py
LR = 1e-3
# (stages, data, microbatches, batch) of each toy schedule, by world
TOYS = {2: [(2, 1, None, B), (2, 1, 4, B)],
        4: [(4, 1, None, B), (2, 2, None, B), (4, 1, None, 6)]}
# the meshes of each world: (data, model, seq) for sequence parallelism,
# (stages, data) for the pipeline
SP_MESHES = {2: {"seq2": (1, 1, 2)},
             4: {"dp2_seq2": (2, 1, 2), "dp2_seq2_fsdp": (2, 1, 2), "seq2_tp2": (1, 2, 2)}}
PP_MESHES = {2: {"pp2": (2, 1)}, 4: {"pp4": (4, 1), "pp2_dp2": (2, 2)}}
ZERO_GRAD = "k_proj.bias"  # SigLIP's key bias: its gradient is rounding noise


def _plain(cfg):
    """A plain-dict copy of a config (the ranks unpickle no JAX class)."""
    return json.loads(json.dumps(cfg))


# ---------------------------------------------------------------------------
# The ranks (spawned processes, without JAX)
# ---------------------------------------------------------------------------


class _Recording(t_optim.AdamW):
    """An optimizer that records the gradients it is handed and does not
    step."""

    def step(self, grads):
        self.seen = [torch.zeros_like(p) if g is None else g.detach().clone()
                     for p, g in zip(self.params, grads)]


def _pi0(payload, kind):
    model = PiZero(payload["cfg"][kind], device="cpu", dtype=torch.float32)
    t_ckpt.load_jax_params(model, payload["tree"][kind])
    return model


def _one_card_names(model, mesh, tensors):
    """{one-card name: numpy} of ``tensors`` ({name: tensor} of the rank's
    model), gathered over the mesh; None on every rank but rank 0."""
    tree, groups = t_fsdp.gather_state(model, mesh, {"t": tensors})
    return None if tree is None else {n: t.numpy() for n, t in groups["t"].items()}


def _handed(model, mesh, trainable, payload, **kw):
    """(loss, {one-card name: the gradient one step hands the optimizer})."""
    opt = _Recording(trainable, lambda c: 0.0)
    step = t_train.make_train_step(model, opt, mesh=mesh, **kw)
    loss = float(step(payload["batch"], *payload["extra"]))
    names = {id(p): n for n, p in model.named_parameters()}
    return loss, _one_card_names(model, mesh, {names[id(p)]: g for p, g in zip(trainable,
                                                                                opt.seen)})


def _sp(payload, mesh, remat=False, fsdp=False):
    model = _pi0(payload, "pp")
    t_mesh.shard_params(model, mesh)
    if fsdp:
        t_fsdp.shard_fsdp(model, mesh)
    rows = t_train.record_token_rows(model)
    loss, grads = _handed(model, mesh, apply_mask(model, SCOPES["all"](model)), payload,
                          remat=remat)
    return {"loss": loss, "grads": grads, "rows": rows}


def _pp(payload, mesh, kind="pp", remat=False):
    model = t_pipe.shard_params_pipeline(_pi0(payload, kind), mesh)
    loss, grads = _handed(model, mesh, apply_mask(model, SCOPES["all"](model)), payload,
                          remat=remat, pipeline=t_pipe.PipelineCtx(mesh))
    return {"loss": loss, "grads": grads}


def _pp_adam(payload, mesh):
    """One masked AdamW step (scope action_expert) on JAX's draws: the loss
    and the trainable parameters after it."""
    model = t_pipe.shard_params_pipeline(_pi0(payload, "pp"), mesh)
    trainable = apply_mask(model, SCOPES["action_expert"](model))
    opt = t_optim.AdamW(trainable, lambda c: LR, mesh=mesh,
                        split=t_fsdp.split_axes(model, trainable, mesh))
    step = t_train.make_train_step(model, opt, mesh=mesh, pipeline=t_pipe.PipelineCtx(mesh))
    loss = float(step(payload["batch"], *payload["extra"]))
    names = {id(p): n for n, p in model.named_parameters()}
    return {"loss": loss, "params": _one_card_names(model, mesh,
                                                    {names[id(p)]: p for p in trainable})}


def _toy(payload, mesh, micro, batch):
    """JAX's toy layer, tanh(h @ w + b) + const, through ``gpipe``: this
    stage's layers, the last stage's outputs (its data row's rows) and the
    gradients of sum(h ** 2) (summed over the data rows)."""
    toy = payload["toy"][batch]
    layers = t_pipe.stage_layers(L, mesh)
    w = {i: torch.from_numpy(toy["w"][i]).requires_grad_() for i in layers}
    b = {i: torch.from_numpy(toy["b"][i]).requires_grad_() for i in layers}
    h0, const = (t_mesh.data_rows(torch.from_numpy(toy[k]), mesh) for k in ("h0", "const"))
    n_micro = t_pipe.microbatch_count(batch, mesh.pipe, mesh.data, micro)
    per = h0.shape[0] // n_micro
    outs = {}

    def stage_fn(m, carry):
        h = h0[m * per:(m + 1) * per] if carry is None else carry[0]
        for i in layers:
            h = torch.tanh(h @ w[i] + b[i]) + const[m * per:(m + 1) * per]
        if layers.stop < L:
            return (h,)
        outs[m] = h.detach()
        return (h**2).sum()

    params = [*w.values(), *b.values()]
    loss = t_pipe.gpipe(stage_fn, n_micro, [((per, D), torch.float32)], mesh, params, "cpu")
    grads = t_train.sum_over(list(torch.autograd.grad(loss, params)), range(len(params)),
                             mesh.data_group)
    n = len(layers)
    return {"n_micro": n_micro, "loss": float(loss),
            "out": torch.cat([outs[m] for m in sorted(outs)]).numpy() if outs else None,
            "w": {i: g.numpy() for i, g in zip(layers, grads[:n])},
            "b": {i: g.numpy() for i, g in zip(layers, grads[n:])}}


def _planted(target, attr, value, fn):
    real = getattr(target, attr)
    setattr(target, attr, value)
    try:
        return fn()
    finally:
        setattr(target, attr, real)


def _own_slice_backward(ctx, g):  # the existing gather's backward, in SP's place
    return t_mesh._own(g, ctx.group, ctx.dim), None, None


def _job(world, payload, sp_meshes, pp_meshes):
    out = {}
    for name, mesh in sp_meshes.items():
        out[name] = _sp(payload, mesh, remat=name == "dp2_seq2", fsdp=name.endswith("fsdp"))
    for name, mesh in pp_meshes.items():
        out[name] = _pp(payload, mesh)
    for stages, data, micro, batch in TOYS[world]:
        mesh = next(m for m in pp_meshes.values() if (m.pipe, m.data) == (stages, data))
        out[f"toy-{stages}-{data}-{micro}-{batch}"] = _toy(payload, mesh, micro, batch)
    if world == 2:
        seq2, pp2 = sp_meshes["seq2"], pp_meshes["pp2"]
        out["pp2_remat"] = _pp(payload, pp2, remat=True)
        out["pp2_adaln"] = _pp(payload, pp2, kind="ada")
        out["pp2_adam"] = _pp_adam(payload, pp2)
        out["fault_gather"] = _planted(t_mesh._GatherSum, "backward",
                                       staticmethod(_own_slice_backward),
                                       lambda: _sp(payload, seq2))
        out["fault_share"] = _planted(t_train, "sequence_share", lambda mesh: 1.0,
                                      lambda: _sp(payload, seq2))
        out["fault_stages"] = _planted(t_train, "sum_over_stages",
                                       lambda grads, replicated, mesh: grads,
                                       lambda: _pp(payload, pp2))
    return out


def _rank(rank, world, init_method, payload_path, queue):
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        payload["batch"] = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
        payload["extra"] = tuple(torch.from_numpy(v) for v in payload["extra"])
        t_mesh.init_ranks(rank, world, init_method, "cpu")
        sp_meshes = {n: t_mesh.make_mesh(*m) for n, m in SP_MESHES[world].items()}
        pp_meshes = {n: t_pipe.make_pipeline_mesh(*m) for n, m in PP_MESHES[world].items()}
        out = _job(world, payload, sp_meshes, pp_meshes)
        torch.distributed.destroy_process_group()
        queue.put((rank, out))
    except BaseException as exc:  # the parent raises it
        queue.put((rank, exc))
        raise


def _start(world, tmp, payload):
    """Start ``world`` spawned ranks on ``payload`` (through a file);
    ``_collect`` reads their results."""
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
    """{rank: result} of ``_start``'s ranks; after a failure the others are
    killed at once (they may be waiting on the failed one)."""
    import queue as queue_lib

    world, procs, q, deadline = started
    results, failed = {}, True
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
        failed = False
    finally:
        for p in procs:
            p.join(0.0 if failed else max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
    return results


# ---------------------------------------------------------------------------
# The trainer's runs (subprocesses, started with the spawns)
# ---------------------------------------------------------------------------

TINY, TINY_PP = "config/eval/bridge_tiny.yaml", "config/eval/bridge_tiny_pp.yaml"
CLI = ["--device", "cpu", "--steps", "2", "--log-every", "1", "--train-scope", "action_expert"]
CLI_RUNS = {
    "pp_one": [TINY_PP], "pp2": [TINY_PP, "--pp", "2"], "pp2_dp2": [TINY_PP, "--pp", "2",
                                                                    "--dp", "2"],
    "sp_one": [TINY], "sp2": [TINY, "--sp", "2"],
    "pp2_stop": [TINY_PP, "--pp", "2", "--stop-after", "1"],
}


def _popen(argv, tmp, name):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    log = open(tmp / f"{name}.log", "w")
    return subprocess.Popen([sys.executable, str(REPO_ROOT / "scripts" / "train_pi0_flow_torch.py"),
                             *argv], cwd=REPO_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)


def _cli_argv(name, tmp):
    config, *flags = CLI_RUNS[name]
    argv = ["--config", config, *CLI, *flags, "--metrics-csv", str(tmp / f"{name}.csv"),
            "--save-dir", str(tmp / name)]
    if name == "pp2_stop":
        argv += ["--save-state", str(tmp / "state")]
    return argv


def _wait(proc, tmp, name):
    if proc.wait(SPAWN_DEADLINE_S) != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                           f"{(tmp / f'{name}.log').read_text()[-3000:]}")


# ---------------------------------------------------------------------------
# JAX's side and the fixtures
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


def _cfgs():
    """The tiny config with 4 joint layers (divisible by 2 and 4 stages; the
    sequence-parallel cases use it too), and with an adaLN expert."""
    from tests.util import tiny_pi0_cfg

    pp = tiny_pi0_cfg()
    pp["joint"]["config"]["num_hidden_layers"] = 4
    ada = tiny_pi0_cfg(action_expert_adaptive_mode="adaLN")
    ada["joint"]["config"]["num_hidden_layers"] = 4
    ada["joint"]["config"]["action_expert_adaptive_mode"] = "adaLN"
    ada["mixture"]["action"]["adaptive_mode"] = "adaLN"
    return {"pp": pp, "ada": ada}


def _in_threads(calls):
    """[fn(*args) for fn, *args in calls], each in a thread of its own (XLA
    compiles outside the GIL: two compiles take the time of one)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        return [f.result() for f in [pool.submit(fn, *args) for fn, *args in calls]]


def _toy_arrays(batch):
    rng = np.random.RandomState(0 if batch == B else 2)
    f32 = np.float32
    if batch == B:  # JAX's toy fixture, draw for draw
        w, bias = (rng.randn(L, D, D) * 0.3).astype(f32), (rng.randn(L, D) * 0.1).astype(f32)
        h0, const = rng.randn(B, D).astype(f32), rng.randn(B, D).astype(f32)
    else:  # JAX's odd batch: 6 rows, no constant
        w, bias = (rng.randn(L, D, D) * 0.3).astype(f32), np.zeros((L, D), f32)
        h0, const = rng.randn(batch, D).astype(f32), np.zeros((batch, D), f32)
    return {"w": w, "b": bias, "h0": h0, "const": const}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's trees and the inputs; the spawns and the trainer's runs
    started (they run while ``refs`` computes JAX's side)."""
    import jax
    import jax.numpy as jnp

    from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
    from tests.util import tiny_inputs

    tmp = tmp_path_factory.mktemp("sp_pp")
    procs = {n: _popen(_cli_argv(n, tmp), tmp, n) for n in CLI_RUNS}
    cfgs = _cfgs()
    models = {k: JPiZero(c) for k, c in cfgs.items()}
    def init(i, k):
        m = models[k]
        return m.canonicalize_tied_weights(m.tie_action_proprio_weights(
            jax.block_until_ready(jax.jit(m.init_params)(jax.random.PRNGKey(i)))))

    trees = dict(zip(models, _in_threads([(init, i, k) for i, k in enumerate(models)])))
    inp = tiny_inputs(cfgs["pp"])
    rng = np.random.RandomState(1)
    h, a = cfgs["pp"].horizon_steps, cfgs["pp"].action_dim
    batch = {k: np.asarray(inp[k]) for k in ("input_ids", "attention_mask", "pixel_values",
                                             "proprios")}
    batch["actions"] = rng.randn(2, h, a).astype(np.float32)
    # make_optax_train_step's own draws from PRNGKey(0): the noise and t of
    # every case, so that JAX's one masked AdamW step is its update of the
    # gradients of the same loss
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    extra = (np.asarray(jax.random.normal(k1, batch["actions"].shape, jnp.float32)),
             np.asarray(jax.random.beta(k2, 1.5, 1.0, (2,))))
    payload = {"cfg": {k: _plain(c) for k, c in cfgs.items()},
               "tree": {k: _np(t_) for k, t_ in trees.items()},
               "batch": batch, "extra": extra,
               "toy": {n: _toy_arrays(n) for n in {b_ for w in TOYS.values()
                                                   for *_, b_ in w}}}
    started = {world: _start(world, tmp_path_factory.mktemp(f"world{world}"), payload)
               for world in (2, 4)}
    return {"payload": payload, "models": models, "trees": trees, "started": started,
            "cli": (tmp, procs)}


@pytest.fixture(scope="module")
def refs(setup):
    """JAX's references: flow_loss and its gradients of each tree, one
    masked AdamW step, and the toy's scans."""
    import jax
    import jax.numpy as jnp
    import optax

    from blurr_tpu.models.pi0.trainable import action_expert_mask
    from blurr_tpu.utils.optim import masked_freeze

    payload, models, trees = setup["payload"], setup["models"], setup["trees"]
    b = payload["batch"]
    args = (b["input_ids"], b["attention_mask"], b["pixel_values"], b["proprios"], b["actions"],
            payload["extra"][1], payload["extra"][0])
    def loss_and_grads(kind):
        model = models[kind]
        loss, grads = jax.jit(jax.value_and_grad(lambda p: model.flow_loss(p, *args)))(
            trees[kind])
        return float(loss), _np(grads)

    out = dict(zip(models, _in_threads([(loss_and_grads, k) for k in models])))
    # make_optax_train_step's update of those gradients (its draws are the
    # cases' noise and t)
    tx = masked_freeze(optax.adamw(LR), action_expert_mask(trees["pp"]))
    grads = jax.tree.map(jnp.asarray, out["pp"][1])
    updates, _ = tx.update(grads, tx.init(trees["pp"]), trees["pp"])
    out["adam"] = (out["pp"][0], _np(optax.apply_updates(trees["pp"], updates)))

    def layer(packet, lp):
        h, const = packet
        return (jnp.tanh(h @ lp["w"] + lp["b"]) + const, const), None

    for batch in {b_ for w in TOYS.values() for *_, b_ in w}:
        toy = payload["toy"][batch]
        st = {"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}
        h0, const = jnp.asarray(toy["h0"]), jnp.asarray(toy["const"])

        def scan(st):
            return jax.lax.scan(layer, (h0, const), st)[0][0]

        out[f"toy-{batch}"] = (np.asarray(jax.jit(scan)(st)),
                               _np(jax.jit(jax.grad(lambda s: jnp.sum(scan(s) ** 2)))(st)))
    return out


@pytest.fixture(scope="module")
def two(setup, refs):
    return _collect(setup["started"][2])


@pytest.fixture(scope="module")
def four(setup, refs):
    return _collect(setup["started"][4])


@pytest.fixture(scope="module")
def cli(setup, refs):
    """The trainer's runs: (tmp, {run: losses}); the stopped --pp 2 run
    resumed on one card first."""
    tmp, procs = setup["cli"]
    _wait(procs["pp2_stop"], tmp, "pp2_stop")
    resumed = {name: _popen(["--config", TINY_PP, *CLI, *flags, "--resume-state",
                             str(tmp / "state"), "--save-dir", str(tmp / name)], tmp, name)
               for name, flags in (("resumed", []), ("resumed_pp2", ["--pp", "2"]))}
    for name, proc in {**procs, **resumed}.items():
        _wait(proc, tmp, name)

    def losses(name):
        return [float(r.split(",")[1]) for r in
                (tmp / f"{name}.csv").read_text().splitlines()[1:]]

    return tmp, {n: losses(n) for n in CLI_RUNS if n != "pp2_stop"}


def _pairs(setup, kind, tree):
    """[(one-card name, JAX's array)] of every parameter of the tree."""
    model = _pi0({"cfg": setup["payload"]["cfg"], "tree": setup["payload"]["tree"]}, kind)
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], want) for p, want in t_ckpt._pairs(model, tree)
            if isinstance(p, torch.nn.Parameter)]


def _worst(got, pairs, rtol, atol, skip=()):
    """The worst leaf's max |port - JAX| over JAX's bound (atol + rtol |JAX|),
    over the leaves ``got`` names; >1 is outside it."""
    worst, n = 0.0, 0
    for name, want in pairs:
        if name not in got or any(s in name for s in skip):
            continue
        worst = max(worst, float((np.abs(got[name] - want) / (atol + rtol * np.abs(want))).max()))
        n += 1
    return worst, n


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


def test_sp_flow_loss_and_grads_match(setup, refs, two):
    got, (want_loss, jgrads) = two[0]["seq2"], refs["pp"]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=SP_LOSS_RTOL)
    worst, n = _worst(got["grads"], _pairs(setup, "pp", jgrads), SP_RTOL, SP_ATOL)
    print(f"seq2: {n} gradient leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(got["grads"]) and worst <= 1.0


@pytest.mark.parametrize("mesh", list(SP_MESHES[4]))
def test_sp_composes_with_dp_fsdp_and_tp(setup, refs, four, mesh):
    """data 2 x seq 2 with remat, with FSDP, and seq 2 x model 2: the loss
    of every rank and every gradient (gathered to the one-card tree)
    against JAX's unsharded run."""
    want_loss, jgrads = refs["pp"]
    for r in range(4):
        np.testing.assert_allclose(four[r][mesh]["loss"], want_loss, rtol=SP_LOSS_RTOL)
    got = four[0][mesh]["grads"]
    worst, n = _worst(got, _pairs(setup, "pp", jgrads), SP_RTOL, SP_ATOL)
    print(f"{mesh}: {n} gradient leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(got) > 0 and worst <= 1.0


def test_sp_shards_the_sequence_axis(setup, two, four):
    """Each rank's SigLIP layers took 1/seq of the patches and its vlm
    layers 1/seq of the tokens (4 and 12 in the tiny config)."""
    cfg = setup["payload"]["cfg"]["pp"]
    patches, tokens = cfg["vision"]["config"]["num_image_tokens"], cfg["max_image_text_tokens"]
    layers = cfg["joint"]["config"]["num_hidden_layers"]
    for res in (two[0]["seq2"], two[1]["seq2"], four[0]["seq2_tp2"], four[3]["dp2_seq2"]):
        assert res["rows"]["siglip"] == [patches // 2] * cfg["vision"]["config"]["num_hidden_layers"]
        assert res["rows"]["vlm"] == [tokens // 2] * layers


def test_sp_rejects_pipeline_combination(setup):
    model = _pi0(setup["payload"], "pp")
    b = {k: torch.from_numpy(v) for k, v in setup["payload"]["batch"].items()}
    noise, t = (torch.from_numpy(x) for x in setup["payload"]["extra"])
    with pytest.raises(ValueError, match="sequence parallelism") as err:
        model.flow_loss(*b.values(), t, noise, sp=t_mesh.Mesh(seq=2),
                        pipeline=t_pipe.PipelineCtx(t_mesh.Mesh(pipe=2)))
    assert str(err.value) == ("sequence parallelism (sp_axis) and pipeline parallelism use "
                              "different meshes; compose sp with data/tensor axes instead")


def test_sp_constrain_refuses_an_axis_that_does_not_split():
    with pytest.raises(ValueError, match="an axis of 5 does not split over 2 ranks"):
        t_mesh.sp_constrain(torch.zeros(1, 5, 3), t_mesh.Mesh(seq=2))


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [f"toy-{s}-{d}-{m}-{b}" for w in TOYS.values()
                                 for s, d, m, b in w])
def test_gpipe_schedule_matches_scan(refs, two, four, key):
    """JAX's toy layer through ``gpipe``: the last stages' outputs against
    ``lax.scan``'s (1e-6), every stage's layer gradients against its
    (2e-5 / 1e-6), as JAX's ``pipelined_scan`` is held."""
    stages, data, micro, batch = (None if x == "None" else int(x) for x in key.split("-")[1:])
    res = two if stages * data == 2 else four
    if batch == 6:
        assert res[0][key]["n_micro"] == 3  # 4 does not divide 6: the next valid divisor
    out = np.concatenate([res[d * stages + stages - 1][key]["out"] for d in range(data)])
    want_out, want_grads = refs[f"toy-{batch}"]
    np.testing.assert_allclose(out, want_out, rtol=TOY_RTOL, atol=TOY_RTOL)
    layers = [i for p in range(stages) for i in res[p][key]["w"]]
    assert sorted(layers) == list(range(L))
    for p in range(stages):
        for leaf in ("w", "b"):
            for i, g in res[p][key][leaf].items():
                np.testing.assert_allclose(g, want_grads[leaf][i], rtol=TOY_GRAD_RTOL,
                                           atol=TOY_GRAD_ATOL)


@pytest.mark.parametrize("case", ["pp2", "pp2_remat", "pp4", "pp2_dp2", "pp2_adaln"])
def test_pp_flow_loss_and_grads_match(setup, refs, two, four, case):
    """flow_loss through the GPipe schedule against JAX's plain scan:
    every rank's loss and every gradient (each stage's layers, the
    replicated parameters summed over the pipe group)."""
    res = two if case in two[0] else four
    kind = "ada" if case.endswith("adaln") else "pp"
    want_loss, jgrads = refs[kind]
    for r in res:
        np.testing.assert_allclose(res[r][case]["loss"], want_loss, rtol=PP_LOSS_RTOL)
    grads = res[0][case]["grads"]
    pairs = _pairs(setup, kind, jgrads)
    worst, n = _worst(grads, pairs, PP_RTOL, PP_ATOL)
    print(f"{case}: {n} gradient leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(grads) == len(pairs) and worst <= 1.0


def test_pp_train_step_matches_unpipelined(setup, refs, two):
    """One masked AdamW step at 2 stages against JAX's plain step."""
    got = two[0]["pp2_adam"]
    want_loss, jparams = refs["adam"]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=PP_LOSS_RTOL)
    worst, n = _worst(got["params"], _pairs(setup, "pp", jparams), PP_RTOL, PP_ATOL)
    print(f"pp2 AdamW step: {n} trainable leaves, worst {worst:.3f} of JAX's bound")
    assert n == len(got["params"]) > 0 and worst <= 1.0


def test_planted_faults_read_outside_the_bound(setup, refs, two):
    sp_pairs = _pairs(setup, "pp", refs["pp"][1])
    pp_pairs = _pairs(setup, "pp", refs["pp"][1])
    gather, _ = _worst(two[0]["fault_gather"]["grads"], sp_pairs, SP_RTOL, SP_ATOL,
                       skip=(ZERO_GRAD,))
    share, _ = _worst(two[0]["fault_share"]["grads"], sp_pairs, SP_RTOL, SP_ATOL,
                      skip=(ZERO_GRAD,))
    stages, _ = _worst(two[0]["fault_stages"]["grads"], pp_pairs, PP_RTOL, PP_ATOL)
    sound_sp, _ = _worst(two[0]["seq2"]["grads"], sp_pairs, SP_RTOL, SP_ATOL)
    sound_pp, _ = _worst(two[0]["pp2"]["grads"], pp_pairs, PP_RTOL, PP_ATOL)
    print(f"sound seq2 {sound_sp:.3f}, pp2 {sound_pp:.3f}; the own-slice gather {gather:.3g}, "
          f"the seq ranks' losses whole {share:.3g}, no sum over the stages {stages:.3g} "
          "(of JAX's bound)")
    assert max(sound_sp, sound_pp) <= 1.0 < min(gather, share, stages)


def test_microbatch_count_is_jax_rule():
    """JAX's default (``blurr_tpu/parallel/pipeline.py:141-157``) and its
    checks of an explicit count, message for message."""
    assert [t_pipe.microbatch_count(b, 4) for b in (2, 4, 6, 8, 64)] == [2, 4, 3, 4, 8]
    assert t_pipe.microbatch_count(2, 2, 2) == 1 and t_pipe.microbatch_count(64, 2, 2) == 4
    for args, message in (((2, 2, 1, 3), "batch 2 not divisible by 3 microbatches"),
                          ((4, 2, 4, 2), "microbatch rows 2 not divisible by the 'data' axis (4)"),
                          ((3, 2, 2, None), "no microbatch count divides batch 3 with data axis 2; "
                                            "pad the batch or set ctx.microbatches")):
        with pytest.raises(ValueError) as err:
            t_pipe.microbatch_count(*args)
        assert str(err.value) == message


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run, one", [("pp2", "pp_one"), ("pp2_dp2", "pp_one"),
                                      ("sp2", "sp_one")])
def test_trainer_follows_one_card(cli, run, one):
    tmp, losses = cli
    assert len(losses[one]) == 2
    np.testing.assert_allclose(losses[run], losses[one], rtol=CLI_RTOL, atol=CLI_ATOL)
    want, got = (t_ckpt.read_safetensors(str(tmp / n / "params.safetensors")) for n in (one, run))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=CLI_RTOL, atol=CLI_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("resumed", ["resumed", "resumed_pp2"])
def test_pp_save_state_resumes_on_one_card(cli, resumed):
    """A --pp 2 run stopped after one step saved the one-card state (every
    stage's layers); a run resumed from it on one card, or again at --pp 2
    (each stage cutting its own layers), ends with the uninterrupted
    one-card run's tree."""
    tmp, _ = cli
    state = t_ckpt.read_safetensors(str(tmp / "state" / "params.safetensors"))
    n_layers = {int(n.split(".")[3]) for n in state if t_pipe.is_staged(n)}
    assert n_layers == set(range(4))
    want = t_ckpt.read_safetensors(str(tmp / "pp_one" / "params.safetensors"))
    got = t_ckpt.read_safetensors(str(tmp / resumed / "params.safetensors"))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=CLI_RTOL, atol=CLI_ATOL,
                                   err_msg=name)


def _cli_module():
    scripts = str(REPO_ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import importlib

    return importlib.import_module("train_pi0_flow_torch")


@pytest.mark.parametrize("flags, message", [
    (["--pp", "2", "--tp", "2"], "--pp composes with --dp only; drop --tp/--sp/--fsdp"),
    (["--pp", "2", "--sp", "2"], "--pp composes with --dp only; drop --tp/--sp/--fsdp"),
    (["--pp", "2", "--dp", "2", "--fsdp"], "--pp composes with --dp only; drop --tp/--sp/--fsdp"),
    (["--sp", "2", "--fsdp"], "--fsdp shards over the 'data' axis; it needs --dp > 1"),
    (["--config", TINY_PP, "--pp", "2", "--pp-microbatches", "3"],
     "batch 2 not divisible by 3 microbatches"),
    (["--config", TINY, "--pp", "2"], "joint.vlm.layers: 3 layers not divisible by 2 pipeline "
                                      "stages"),
])
def test_jax_refusals(flags, message):
    with pytest.raises(SystemExit) as err:
        _cli_module().main(["--device", "cpu", *flags])
    assert str(err.value) == message
