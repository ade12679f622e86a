"""Tensor and data parallelism of the port on spawned ``gloo`` ranks (one
process each, rendezvous through a ``FileStore`` under the test's
temporary directory), against the JAX package on the CPU.

One spawn per world shape, in module-scoped fixtures whose results the
cases read:

- tp=2 (two ranks): the tiny fp32 Pi-0 with JAX's weights carried across
  (``load_jax_params``), sharded in the port, within JAX's own ``rtol=5e-4,
  atol=5e-5`` (``tests/test_parallel.py``) of JAX's single-device output and
  of JAX's output under ``make_mesh(1, 2)`` with ``shard_params``; the w4a8
  tiny Pi-0, each of whose w4a8 products (the rank's blocks, and the whole
  k and v products on their packing re-laid for the model axis, every
  call) is bit-equal to the unsharded ``W4A8Linear`` of the port's tp=1
  model on the same input; a row-parallel w8a8 product equal to JAX's ``w8a8_mm`` on the
  same bytes (its activation scale the max over the whole K), where a
  rank-local max, planted in the rank, reads far outside that; the tiny
  OpenVLA's greedy tokens, bf16 and w4a8, equal to JAX's; and
  ``main_rank_only`` running on rank 0 alone.
- dp=2 x tp=2 (four ranks): the same Pi-0 with the batch of 2 split over
  the data ranks, against JAX's single-device output and its output under
  ``make_mesh(2, 2)``.

Then the entry points: ``ActionServer(tp=2)`` and ``(dp=2, max_batch=2)``
answer through TCP as a one-process server with the same weights does
(fp32 within ``SERVE_TOL``: the row sums' other order); a reload under tp=2
serves the reloaded weights, atomic and ``drop_first`` (a failed one leaves
no weights on any rank, a good one recovers); a rank that raises makes the server raise
within ``FAULT_DEADLINE_S`` and stay failed; ``eval_openloop_torch.py --dp
2`` gives ``--dp 1``'s metrics within ``OPENLOOP_RTOL`` (a CPU matmul of
another row count rounds otherwise) and hands back its data rank's kernel
counts. Every rank runs one thread; every
spawn is joined by a deadline.
"""

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from blurr_tpu_torch.models.openvla import model as t_vla
from blurr_tpu_torch.models.openvla.checkpoint import load_jax_params as load_vla_params
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params, save_torch_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.parallel import mesh as t_mesh
from blurr_tpu_torch.parallel import tensor_parallel as tp
from blurr_tpu_torch.serving.client import ActionClient
from blurr_tpu_torch.serving.server import ActionServer
from blurr_tpu_torch.utils.decorator import main_rank_only

JAX_RTOL, JAX_ATOL = 5e-4, 5e-5  # tests/test_parallel.py
SERVE_TOL = 1e-5
OPENLOOP_RTOL = 1e-5
FAULT_DEADLINE_S = 10.0
SPAWN_DEADLINE_S = 120.0
W8A8_K, W8A8_N = 64, 16


def _plain(cfg):
    """A plain-dict copy of a config (the ranks unpickle no JAX class)."""
    return json.loads(json.dumps(cfg))


def _pi0_cfg(**overrides):
    from tests.util import tiny_pi0_cfg

    return _plain(tiny_pi0_cfg(**overrides))


W4A8_CFG = {"action_quantization": {"mode": "w4a8"},
            "vlm_quantization": {"mode": "w4a8", "include_vision": True}}


def _w4a8_model():
    model = PiZero(_pi0_cfg(**W4A8_CFG), device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(5))
    return model.enable_action_quantization().enable_vlm_quantization()


def _w8a8_case():
    rng = np.random.RandomState(7)
    w = rng.randn(W8A8_N, W8A8_K).astype(np.float32) * 0.1
    x = rng.randn(3, 5, W8A8_K).astype(np.float32)
    x[:, :, -1] *= 40.0  # every token's absmax lies in rank 1's half of K
    lin = torch.nn.Linear(W8A8_K, W8A8_N, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    return tq.W8A8Linear.from_linear(lin), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# The ranks (these run in the spawned processes)
# ---------------------------------------------------------------------------


def _pi0_run(payload, mesh):
    model = PiZero(payload["cfg"], device="cpu", dtype=torch.float32)
    load_jax_params(model, payload["tree"])
    t_mesh.shard_params(model, mesh)
    inputs = [torch.from_numpy(a) for a in payload["inputs"]]
    rows = [t_mesh.data_rows(a, mesh) for a in inputs]
    out = t_mesh.all_gather(model.infer_action(*rows), mesh.data_group, 0)
    return out.numpy()


def _w4a8_products(mesh, inputs):
    """(name, input, output, cols, packing) of every w4a8 product of the sharded
    w4a8 tiny Pi-0's step: each W4A8Blocks call, and each call of a whole
    W4A8Linear (k and v), which runs on the packing re-laid for the model
    axis."""
    model = t_mesh.shard_params(_w4a8_model(), mesh)
    seen = []

    def hook(name):
        def record(mod, args, out):
            seen.append((name, args[0].numpy().copy(), out.numpy().copy(),
                         getattr(mod, "cols", None), tuple(mod.q4.shape)))
        return record

    for name, mod in model.named_modules():
        # the TP blocks, and the whole k / v products on their re-laid packing
        if isinstance(mod, (tp.W4A8Blocks, tq.W4A8Linear)):
            mod.register_forward_hook(hook(name.replace(".local", "")))
    model.infer_action(*[torch.from_numpy(a) for a in inputs])
    return seen


def _w8a8_row(mesh, planted: bool):
    lin, x = _w8a8_case()
    row = tp.parallel_linear(lin, t_mesh.ROW, mesh)
    if not planted:
        return row(x).numpy()
    real = tp.all_reduce_max
    tp.all_reduce_max = lambda t, group: t  # the rank-local max
    try:
        return row(x).numpy()
    finally:
        tp.all_reduce_max = real


def _openvla_tokens(payload, mesh, quant):
    dtype = torch.bfloat16
    model = t_vla.OpenVLA(t_vla.OpenVLASpec.tiny(), device="cpu", dtype=dtype, quant_init=quant)
    load_vla_params(model, payload["vla_trees"][quant or "bf16"])
    t_mesh.shard_params(model, mesh)
    ids, px = (torch.from_numpy(a) for a in payload["vla_inputs"])
    return model.predict_action_tokens(ids, px.to(dtype)).numpy()


def _job(rank, world, payload, mesh):
    if world == 2:
        return {
            "pi0": _pi0_run(payload, mesh),
            "w4a8": _w4a8_products(mesh, payload["inputs"]),
            "w8a8_row": _w8a8_row(mesh, planted=False),
            "w8a8_row_local_max": _w8a8_row(mesh, planted=True),
            "vla_bf16": _openvla_tokens(payload, mesh, None),
            "vla_w4a8": _openvla_tokens(payload, mesh, "w4a8"),
            "main_rank_only": main_rank_only(lambda: f"ran on {rank}")(),
        }
    return {"pi0": _pi0_run(payload, mesh)}


def _rank(rank, world, data, init_method, payload_path, queue):
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        t_mesh.init_ranks(rank, world, init_method, "cpu")
        mesh = t_mesh.make_mesh(data, world // data)
        out = _job(rank, world, payload, mesh)
        torch.distributed.destroy_process_group()
        queue.put((rank, out))
    except BaseException as exc:  # the parent raises it
        queue.put((rank, exc))
        raise


def _spawn(world, data, tmp, payload):
    """Run ``_job`` on ``world`` spawned ranks (``data`` data rows) and
    return {rank: result}. The payload goes through a file: a large one
    written to each child's pipe would start the children one by one."""
    import multiprocessing as mp
    import queue as queue_lib

    path = tmp / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, data, f"file://{tmp}/store", str(path), q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_DEADLINE_S
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
def one_thread_ranks():
    """Every rank (this process's and the spawned ones) on one thread; the
    servers' stub tokenizer without a search for ``transformers`` first."""
    import sys

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setitem(sys.modules, "transformers", None)
        yield
    torch.set_num_threads(threads)


def _draw(shapes, seed):
    """A tree of JAX's shapes drawn from a numpy seed (no JAX init to
    compile), with JAX init's scales: matrices N(0, 1/fan_in), norm and
    LayerScale weights 1 + N(0, 0.02^2), other vectors N(0, 0.02^2)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if s.dtype == jnp.int8:  # packed w4a8 bytes: random nibble pairs
            return jnp.asarray(rng.randint(-128, 128, s.shape).astype(np.int8))
        if getattr(path[-1], "key", None) == "s":  # w4a8 group scales, ~1/(7 sqrt(K))
            return jnp.full(s.shape, 0.015, s.dtype)
        name = str(getattr(path[-1], "key", ""))
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.02
        one = len(s.shape) == 1 and ("norm" in name or name.startswith(("ln", "ls")))
        return jnp.asarray((one + rng.randn(*s.shape) * scale).astype(np.float32), s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def refs():
    """JAX's tiny Pi-0 tree and its outputs (single device, (1, 2) and
    (2, 2) meshes), and the tiny OpenVLA's trees and greedy tokens."""
    import jax
    import jax.numpy as jnp

    from blurr_tpu.models.openvla import llama as j_llama
    from blurr_tpu.models.openvla import model as j_vla
    from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
    from blurr_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params
    from tests.util import tiny_inputs, tiny_pi0_cfg

    cfg = tiny_pi0_cfg()
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(_draw(jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(0))), 0))
    inputs = tiny_inputs(cfg)
    infer = jax.jit(jm.infer_action)
    out = {"single": np.asarray(infer(params, **inputs))}
    for name, (data, model) in (("mesh_1x2", (1, 2)), ("mesh_2x2", (2, 2))):
        mesh = make_mesh(data=data, model=model)
        args = inputs
        if data > 1:
            args = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in inputs.items()}
        with mesh:
            out[name] = np.asarray(infer(shard_params(params, mesh), **args))
    names = ("input_ids", "attention_mask", "pixel_values", "proprios", "noise")
    payload = {"cfg": _plain(cfg), "tree": jax.tree.map(np.asarray, params),
               "inputs": [np.asarray(inputs[k]) for k in names]}

    spec = j_vla.OpenVLASpec.tiny()
    vla = j_vla.OpenVLA(spec)
    key = jax.random.PRNGKey(0)
    vla_params = _draw(jax.eval_shape(lambda: vla.init_params(key, jnp.bfloat16)), 1)
    rng = np.random.RandomState(1)
    ids = rng.randint(3, 31000, (1, 8)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 1, j_vla.EMPTY_TOKEN
    px = rng.rand(1, 6, 28, 28).astype(np.float32)
    trees, tokens = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        # JAX's w4a8 products through its Pallas kernel (interpret mode: the
        # exact int32 group dots K2 replaces), not its dequantizing XLA route
        mp.setenv("BLURR_INT4_FORCE", "interpret")
        predict = jax.jit(vla.predict_action_tokens)
        for quant in ("bf16", "w4a8"):
            p = vla_params
            if quant == "w4a8":  # drawn packed, as a checkpoint-free 7B w4a8 is
                p = {**p, "llama": _draw(jax.eval_shape(
                    lambda: j_llama.init_llama_params_w4a8(key, spec.llama)), 2)}
            trees[quant] = jax.tree.map(np.asarray, p)
            tokens[quant] = np.asarray(predict(p, jnp.asarray(ids),
                                               jnp.asarray(px, jnp.bfloat16)))
    payload.update(vla_trees=trees, vla_inputs=(ids, px))
    return {"pi0": out, "vla": tokens, "payload": payload}


@pytest.fixture(scope="module")
def tp2(refs, tmp_path_factory):
    return _spawn(2, 1, tmp_path_factory.mktemp("tp2"), refs["payload"])


@pytest.fixture(scope="module")
def dp2_tp2(refs, tmp_path_factory):
    payload = {k: v for k, v in refs["payload"].items() if not k.startswith("vla")}
    return _spawn(4, 2, tmp_path_factory.mktemp("dp2tp2"), payload)


# ---------------------------------------------------------------------------
# The sharded model against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref", ["single", "mesh_1x2"])
def test_pi0_tp2_matches_jax(tp2, refs, ref):
    for rank in (0, 1):  # both ranks hold the whole answer
        np.testing.assert_allclose(tp2[rank]["pi0"], refs["pi0"][ref], rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


@pytest.mark.parametrize("ref", ["single", "mesh_2x2"])
def test_pi0_dp2_tp2_matches_jax(dp2_tp2, refs, ref):
    got = dp2_tp2[0]["pi0"]
    assert got.shape == refs["pi0"][ref].shape  # both data rows gathered on rank 0
    np.testing.assert_allclose(got, refs["pi0"][ref], rtol=JAX_RTOL, atol=JAX_ATOL)


def test_w4a8_products_bit_equal_to_tp1(tp2):
    full = dict(_w4a8_model().named_modules())
    for rank in (0, 1):
        seen = tp2[rank]["w4a8"]
        assert len(seen) > 40  # every mixture's w4a8 linears, every call
        # the whole k / v products ran on their re-laid packing
        relaid = {name for name, *_, q4 in seen if q4 != tuple(full[name].q4.shape)
                  and isinstance(full[name], tq.W4A8Linear) and name.endswith(("k_proj", "v_proj"))}
        assert relaid
        for name, x, out, cols, _ in seen:
            want = full[name](torch.from_numpy(x)).numpy()
            if cols is not None:
                want = want[..., cols[0]:cols[1]]
            np.testing.assert_array_equal(out, want, err_msg=name)


@pytest.mark.parametrize("planted", [False, True])
def test_row_parallel_w8a8_reproduces_jax_activation_scale(tp2, planted):
    """JAX's w8a8_mm on the same int8 bytes: the row-parallel product
    quantizes x with the absmax over the whole K; a rank-local max (planted
    in the ranks) reads far outside the bound."""
    import jax.numpy as jnp

    from blurr_tpu.ops import quant as jq

    lin, x = _w8a8_case()
    want = np.asarray(jq.w8a8_mm(jnp.asarray(x.numpy()), {
        "q8a": jnp.asarray(lin.q8a.contiguous().numpy()), "s": jnp.asarray(lin.s.numpy())}))
    bound = 1e-6 * np.abs(want).max()
    for rank in (0, 1):
        err = np.abs(tp2[rank]["w8a8_row_local_max" if planted else "w8a8_row"] - want).max()
        if planted:
            assert err > 1e3 * bound, err
        else:
            assert err <= bound, err


@pytest.mark.parametrize("quant", ["bf16", "w4a8"])
def test_openvla_tp2_tokens_equal_jax(tp2, refs, quant):
    for rank in (0, 1):
        np.testing.assert_array_equal(tp2[rank][f"vla_{quant}"], refs["vla"][quant])


def test_main_rank_only_runs_on_rank_0(tp2):
    assert [tp2[r]["main_rank_only"] for r in (0, 1)] == ["ran on 0", None]


# ---------------------------------------------------------------------------
# The servers and the open-loop evaluator
# ---------------------------------------------------------------------------


def _serve_cfg():
    """The serving tests' tiny config (room for the stub tokenizer's ids)."""
    from blurr_tpu_torch.presets import apply_preset

    cfg = _pi0_cfg(vocab_size=1024, image_token_index=1000)
    apply_preset(cfg, "prefix_cache")
    cfg["num_inference_steps"] = 2
    return cfg


def _requests(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (28, 28, 3), np.uint8), ("pick up the carrot", "go")[i % 2],
             rng.uniform(-1, 1, 7).tolist()) for i in range(n)]


def _answers(srv, requests):
    import threading

    ready = threading.Event()
    thread = threading.Thread(target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
                              daemon=True)
    thread.start()
    assert ready.wait(30)
    try:
        with ActionClient(port=srv.port) as client:
            answers = [client.predict(*r) for r in requests]
            stats = client.stats()
    finally:
        srv.stop()
        thread.join(30)
    return answers, stats


@pytest.mark.parametrize("kw,ref_kw", [
    ({"tp": 2}, {}),
    ({"dp": 2, "max_batch": 2}, {"max_batch": 2, "bucket_mode": "max"}),
])
def test_server_answers_as_one_process(kw, ref_kw, tmp_path):
    """Through TCP, request by request: the same weights (drawn from the
    seed on every rank) and the same buckets (dp's smallest bucket is 2,
    so the reference pads to 2 too: the noise is a draw of the bucket's
    shape)."""
    requests = _requests()
    want, _ = _answers(ActionServer(_serve_cfg(), "random", device="cpu", seed=3, **ref_kw),
                       requests)
    srv = ActionServer(_serve_cfg(), "random", device="cpu", seed=3,
                       init_method=f"file://{tmp_path}/store", **kw)
    assert srv.backend == "gloo" and (srv.tp, srv.dp) == (kw.get("tp", 1), kw.get("dp", 1))
    got, stats = _answers(srv, requests)
    assert (stats["tp"], stats["dp"], stats["requests_total"]) == (srv.tp, srv.dp, 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=SERVE_TOL)


def test_reload_under_tp2_serves_the_new_weights(tmp_path):
    cfg = _serve_cfg()
    other = PiZero(cfg, device="cpu", dtype=torch.float32)
    other.init_params(torch.Generator().manual_seed(11))
    save_torch_checkpoint(other, str(tmp_path / "other.pt"))
    requests = _requests(2, seed=1)
    want, _ = _answers(ActionServer(cfg, str(tmp_path / "other.pt"), device="cpu", seed=3),
                       requests)
    srv = ActionServer(cfg, "random", device="cpu", seed=3, tp=2,
                       init_method=f"file://{tmp_path}/store")
    try:
        before = srv.predict(*requests[0])
        srv._req_idx = 0  # the reference's noise index
        assert srv.reload_checkpoint(str(tmp_path / "other.pt"))["reloaded"].endswith("other.pt")
        with pytest.raises(FileNotFoundError):  # on every rank: the new weights stay
            srv.reload_checkpoint(str(tmp_path / "missing.pt"))
        # drop_first: a failed load leaves no weights on any rank, a good one recovers
        with pytest.raises(FileNotFoundError):
            srv.reload_checkpoint(str(tmp_path / "missing.pt"), drop_first=True)
        with pytest.raises(RuntimeError, match="no weights loaded"):
            srv.predict(*requests[0])
        srv.reload_checkpoint(str(tmp_path / "other.pt"), drop_first=True)
        srv._req_idx = 0
    except BaseException:
        srv.stop()
        raise
    got, stats = _answers(srv, requests)
    assert stats["reloads_total"] == 2 and not np.allclose(before, want[0], atol=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=SERVE_TOL)


class FaultyRankServer(ActionServer):
    """Rank 1 raises in every step."""

    def _infer(self, *tensors):
        if self.rank == 1:
            raise RuntimeError("planted fault on rank 1")
        return super()._infer(*tensors)


def test_a_rank_that_raises_makes_the_server_raise(tmp_path):
    srv = FaultyRankServer(_serve_cfg(), "random", device="cpu", seed=3, tp=2,
                           init_method=f"file://{tmp_path}/store")
    request = _requests(1)[0]
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 failed.*planted fault"):
            srv.predict(*request)
        assert time.monotonic() - t0 < FAULT_DEADLINE_S
        with pytest.raises(RuntimeError, match="broken"):
            srv.predict(*request)
        assert srv.stats()["errors_total"] == 2
    finally:
        t0 = time.monotonic()
        srv.stop()
    assert time.monotonic() - t0 < FAULT_DEADLINE_S


def test_openloop_dp2_gives_dp1_metrics(tmp_path):
    """6 examples in batches of 4: the last batch has 2 live rows, all on
    data rank 0."""
    import importlib

    cli = importlib.import_module("scripts.eval_openloop_torch")
    argv = ["--config", "config/eval/bridge_tiny.yaml", "--checkpoint", "random",
            "--examples", "6", "--batch-size", "4", "--device", "cpu"]
    want = cli.main(argv)
    rank_launches = []
    got = cli.main(argv + ["--dp", "2", "--output-json", str(tmp_path / "m.json")],
                   rank_launches=rank_launches)
    # the data rank's counts come back (on the CPU no kernel launches)
    assert rank_launches == [{"flash_attention": 0, "int4_matmul": 0, "int8_matmul": 0}]
    assert json.loads((tmp_path / "m.json").read_text()) == got
    assert got.keys() == want.keys() and got["examples"] == want["examples"] == 6
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= OPENLOOP_RTOL * abs(v), (k, got[k], v)
        elif k == "per_dim_mse":
            np.testing.assert_allclose(got[k], v, rtol=OPENLOOP_RTOL)
        else:
            assert got[k] == v, k
    assert not os.path.exists(tmp_path / "store")
