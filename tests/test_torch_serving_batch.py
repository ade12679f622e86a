"""Dynamic batching in the port's servers (``serving/server.py``,
``serving/openvla_server.py``) on the CPU, against JAX's.

JAX's and the port's ``ActionServer`` load one ``.pt`` (written by the
port's ``save_torch_checkpoint``) with the same seed,
and the same prepared requests go through ``_run_batch`` on both: a bucket's
noise is one draw ``normal(fold_in(PRNGKey(seed), batch_idx), (bucket,
n_tok, act_dim))`` in both packages. Tolerances as
``tests/test_torch_checkpoint.py`` states them: fp32 (baseline) atol 1e-4,
bf16 (blurr) atol 5e-2. On the port alone, a row of a bucket against a
batch-1 step on its inputs and its noise row: fp32 within 1e-5, the
repo's bound for the same formulas summed in another order (a CPU matmul
of another M blocks its sums otherwise: the rows read 4.2e-7 to 1.22e-6
apart, varying between processes with the buffers' alignment). Then the batcher as
``tests/test_serving.py`` drives JAX's: concurrent TCP clients, requests
validated in the caller's thread, every bucket warmed, backpressure,
shutdown; the stats keys against JAX's; and OpenVLA's ragged, Jacobi and OFT
buckets, each row its request's solo answer. The JAX cases use one bucket
size each (JAX compiles a program per bucket)."""

import threading
import time

import numpy as np
import pytest

import torch

from blurr_tpu.serving import server as j_server
from blurr_tpu.serving.client import ActionClient
from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.presets import apply_preset
from blurr_tpu_torch.serving import server as t_server
from blurr_tpu_torch.serving.client import ActionClient as PortActionClient
from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer
from blurr_tpu_torch.serving.server import ActionServer
from tests.util import tiny_pi0_cfg

INSTRUCTIONS = ("put the spoon on the towel", "pick up the carrot",
                "move the very shiny red spoon onto the blue towel")


def _cfg(preset="prefix_cache"):
    """tiny_pi0_cfg with room for the stub tokenizer's ids (up to 999)."""
    cfg = tiny_pi0_cfg(vocab_size=1024, image_token_index=1000)
    apply_preset(cfg, preset)
    cfg["num_inference_steps"] = 2
    return cfg


def _requests(n, size=28, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (size, size, 3), np.uint8), INSTRUCTIONS[i % 3],
             rng.uniform(-1, 1, 7).tolist()) for i in range(n)]


def _run_direct_batch(srv, pending_cls, requests):
    """One bucket through ``_run_batch``, as the batcher runs it, with the
    batch composition exact (no thread racing)."""
    pend = [pending_cls(srv._prepare(*r)) for r in requests]
    srv._run_batch(pend)
    for p in pend:
        if p.error is not None:
            raise p.error
    return [p.result for p in pend]


def _serve(srv):
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
                         daemon=True)
    t.start()
    assert ready.wait(30)
    return t


def _stop(srv, thread):
    srv.stop()
    thread.join(30)
    assert not thread.is_alive()


def write_pt(cfg, seed, path) -> str:
    """Random tiny fp32 weights written as a reference .pt by the port."""
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(seed))
    save_torch_checkpoint(model, str(path))
    return str(path)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return write_pt(_cfg(), 0, tmp_path_factory.mktemp("batch") / "pi0.pt")


@pytest.mark.parametrize("preset,bucket_mode,tol", [("baseline", "pow2", 1e-4),
                                                    ("blurr", "max", 5e-2)])
def test_batched_step_matches_jax(saved, preset, bucket_mode, tol):
    """3 requests padded to a bucket of 4 (the next power of 2, or
    max_batch): the port's rows are JAX's; then one request through each
    batcher under 'max' (the same bucket), whose stats keys cover JAX's."""
    cfg = _cfg(preset)
    reqs = _requests(3)
    jax_srv = j_server.ActionServer(cfg, saved, seed=5, max_batch=4, bucket_mode=bucket_mode)
    port_srv = ActionServer(cfg, saved, device="cpu", seed=5, max_batch=4,
                            bucket_mode=bucket_mode)
    try:
        want = _run_direct_batch(jax_srv, j_server._PendingRequest, reqs)
        got = _run_direct_batch(port_srv, t_server._PendingRequest, reqs)
        for g, w in zip(got, want):
            assert g.shape == (4, 7)
            np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=0)
        assert not np.array_equal(got[0], got[1])
        if bucket_mode == "max":
            one = jax_srv.predict(*reqs[0])
            np.testing.assert_allclose(port_srv.predict(*reqs[0]), one, atol=tol, rtol=0)
            j_stats, t_stats = jax_srv.stats(), port_srv.stats()
            assert set(t_stats) >= set(j_stats) and "batches_total" in j_stats
            for key in ("batches_total", "live_slots_total", "padded_slots_total",
                        "batch_occupancy_mean", "padding_frac", "max_batch", "bucket_mode",
                        "requests_total", "rejected_total", "reloads_total", "dp", "tp"):
                assert t_stats[key] == j_stats[key], key
    finally:
        jax_srv.stop()
        port_srv.stop()


def test_single_server_stats_keys_cover_jax():
    """max_batch 1: the port's stats keys after a request cover JAX's."""
    cfg = _cfg()
    jax_srv = j_server.ActionServer(cfg, "random", seed=0)
    port_srv = ActionServer(cfg, "random", device="cpu", seed=0)
    req = _requests(1)[0]
    jax_srv.predict(*req)
    port_srv.predict(*req)
    j_stats, t_stats = jax_srv.stats(), port_srv.stats()
    assert set(t_stats) >= set(j_stats) and "latency_ms_p99" in j_stats
    assert "batches_total" not in t_stats
    assert t_stats["max_batch"] == 1 and t_stats["device"] == "cpu"


@pytest.mark.parametrize("preset", ["prefix_cache", "baseline"])
def test_rows_are_independent_of_the_bucket(preset):
    """Row i of a bucket is a batch-1 step on request i's inputs with row i
    of the bucket's noise (fp32, within 1e-5: the module docstring); the
    padded row repeats the last request."""
    srv = ActionServer(_cfg(preset), "random", device="cpu", seed=3, max_batch=4)
    try:
        reqs = _requests(3, seed=1)
        got = _run_direct_batch(srv, t_server._PendingRequest, reqs)
        noise = srv.noise(0, 4)
        infer = srv.model.infer_action if srv.prefix_cache else srv.model.infer_action_naive
        for i, req in enumerate(reqs):
            alone = infer(*srv._prepare(*req), noise[i:i + 1])[0].numpy()
            np.testing.assert_allclose(got[i], alone, atol=1e-5, rtol=0)
        assert srv._req_idx == 1  # the index counts batches
        stats = srv.stats()
        assert (stats["batches_total"], stats["live_slots_total"],
                stats["padded_slots_total"]) == (1, 3, 1)
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def batch_server():
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=4,
                       batch_window_ms=25.0)
    thread = _serve(srv)
    yield srv
    _stop(srv, thread)


def test_batched_concurrent_clients(batch_server):
    """6 concurrent clients, JAX's and the port's: each gets its own
    finite chunk in [-1, 1]; the requests share buckets."""
    results = {}

    def hit(i):
        client_cls = ActionClient if i % 2 else PortActionClient
        with client_cls(port=batch_server.port) as c:
            img = np.full((28, 28, 3), i * 10, np.uint8)
            results[i] = c.predict(img, INSTRUCTIONS[i % 3], [0.1 * i] * 7)

    before = batch_server.stats()
    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert len(results) == 6
    for r in results.values():
        assert r.shape == (4, 7) and np.isfinite(r).all() and np.abs(r).max() <= 1.0
    assert len({r.tobytes() for r in results.values()}) == 6
    after = batch_server.stats()
    assert after["requests_total"] - before["requests_total"] == 6
    assert after["batches_total"] - before.get("batches_total", 0) < 6


def test_batched_bad_request_does_not_poison_its_batch(batch_server):
    """A malformed request fails in its own connection; a concurrent good
    one is answered (validation runs before the queue)."""
    out = {}

    def good():
        with PortActionClient(port=batch_server.port) as c:
            out["good"] = c.predict(np.zeros((28, 28, 3), np.uint8), "g", [0.0] * 7)

    def bad():
        with PortActionClient(port=batch_server.port) as c:
            try:
                c.predict(np.zeros((28, 28, 3), np.uint8), "b", [0.0] * 3)
            except RuntimeError as exc:
                out["bad"] = exc

    threads = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert out["good"].shape == (4, 7)
    assert "proprio" in str(out["bad"])


def test_rgba_image_rejected_per_request(batch_server):
    with PortActionClient(port=batch_server.port) as c:
        with pytest.raises(RuntimeError, match="HxWx3"):
            c.predict(np.zeros((28, 28, 4), np.uint8), "rgba", [0.0] * 7)
        assert c.predict(np.zeros((28, 28, 3), np.uint8), "ok", [0.0] * 7).shape == (4, 7)


@pytest.mark.parametrize("max_batch,bucket_mode,buckets", [
    (1, "pow2", [1]), (4, "pow2", [1, 2, 4]), (6, "pow2", [1, 2, 4, 8]), (3, "max", [3]),
])
def test_warmup_runs_every_bucket(max_batch, bucket_mode, buckets):
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=max_batch,
                       bucket_mode=bucket_mode)
    seen = []
    step = srv._step

    def counting(*inputs, request_idx):
        seen.append((inputs[0].shape[0], request_idx))
        return step(*inputs, request_idx=request_idx)

    srv._step = counting
    try:
        assert srv.warmup() > 0
        assert seen == [(b, 0) for b in buckets]
        assert srv._buckets() == buckets
        assert srv.stats()["requests_total"] == 0 and srv._req_idx == 0
    finally:
        srv.stop()


def test_unknown_bucket_mode_is_an_error():
    with pytest.raises(ValueError, match="bucket_mode"):
        ActionServer(_cfg(), "random", device="cpu", max_batch=2, bucket_mode="pow3")


@pytest.mark.parametrize("kw,match", [
    ({"dp": 3, "max_batch": 4}, "power of 2"), ({"dp": 4, "max_batch": 2}, "max_batch >= dp"),
    ({"dp": 2, "max_batch": 3, "bucket_mode": "max"}, "divisible by dp"),
])
def test_parallel_flags_name_their_milestone(kw, match):
    """The data-parallel checks of JAX's ``_init_parallel``, made before any
    rank is spawned (M14's serving half is ported; the flags no longer
    name a milestone)."""
    with pytest.raises(ValueError, match=match):
        ActionServer(_cfg(), "random", device="cpu", **kw)


def test_max_queue_backpressure():
    """With the batcher held inside a batch, one request waits in the
    queue (max_queue 1) and the next is rejected "Overloaded" at once and
    counted; the held requests complete once the batcher resumes (JAX's
    test_max_queue_backpressure)."""
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=2,
                       batch_window_ms=5.0, max_queue=1)
    gate, claimed = threading.Event(), threading.Event()
    run = srv._run_batch

    def gated(batch):
        claimed.set()
        gate.wait(60)
        run(batch)

    srv._run_batch = gated
    img = np.zeros((28, 28, 3), np.uint8)
    results, errors = {}, {}

    def hit(i):
        try:
            results[i] = srv.predict(img, f"bp {i}", [0.0] * 7)
        except RuntimeError as exc:
            errors[i] = str(exc)

    threads = [threading.Thread(target=hit, args=(i,), daemon=True) for i in range(2)]
    try:
        threads[0].start()
        assert claimed.wait(30), "the batcher never claimed the first request"
        threads[1].start()
        deadline = time.monotonic() + 30
        while srv._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats()["queue_depth"] == 1
        with pytest.raises(RuntimeError, match="Overloaded"):
            srv.predict(img, "bp overflow", [0.0] * 7)
        stats = srv.stats()
        assert stats["rejected_total"] == 1 and stats["errors_total"] == 1
    finally:
        gate.set()
        for t in threads:
            t.join(120)
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 2 and not errors
    assert all(a.shape == (4, 7) for a in results.values())


def test_stop_with_requests_in_flight_does_not_hang():
    """stop()'s sentinel lands while the batcher collects a request: the
    request is answered and the batcher ends."""
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=4,
                       batch_window_ms=200.0)
    results, queued = {}, threading.Event()
    put = srv._queue.put

    def put_and_signal(item):
        put(item)
        queued.set()

    srv._queue.put = put_and_signal

    def hit():
        results["out"] = srv.predict(np.zeros((28, 28, 3), np.uint8), "inflight", [0.0] * 7)

    t = threading.Thread(target=hit, daemon=True)
    t.start()
    assert queued.wait(30)
    time.sleep(0.02)  # the batcher holds it inside its 200 ms window
    srv.stop()
    t.join(60)
    assert not t.is_alive(), "the request in flight hung after stop()"
    assert results["out"].shape == (4, 7)
    srv._batcher.join(30)
    assert not srv._batcher.is_alive()


def test_predict_after_stop_raises():
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=4,
                       batch_window_ms=10.0)
    srv.stop()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.predict(np.zeros((28, 28, 3), np.uint8), "late", [0.0] * 7)
    assert srv.stats()["closed"] and srv.stats()["errors_total"] == 1


def test_a_failed_step_fails_its_whole_bucket():
    """An error inside the bucket's step reaches every request of it (none
    is answered from a partial step), and the batcher keeps serving."""
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0, max_batch=4)
    step = srv._step

    def failing(*inputs, request_idx):
        raise RuntimeError("device fault")

    try:
        srv._step = failing
        pend = [t_server._PendingRequest(srv._prepare(*r)) for r in _requests(2)]
        srv._run_batch(pend)
        assert all(str(p.error) == "device fault" and p.result is None for p in pend)
        srv._step = step
        assert srv.predict(*_requests(1)[0]).shape == (4, 7)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# OpenVLA buckets


def _vla_request(seed, instruction, size=28):
    return np.random.RandomState(seed).randint(0, 256, (size, size, 3), np.uint8), instruction


def _vla_server(model_id="random", **kw):
    return OpenVLAActionServer(model_id, use_bf16=False, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{}, {"decode": "jacobi"}])
def test_openvla_ragged_instructions_co_batch(kw):
    """Instructions of 3 token counts in one bucket of 4: each answer is its
    request's solo answer, bit for bit; a Jacobi bucket gives AR's
    tokens."""
    srv = _vla_server(max_batch=4, **kw)
    try:
        reqs = [(*_vla_request(i, instr), None) for i, instr in enumerate(INSTRUCTIONS)]
        lengths = {int(srv._prepare(*r)[1].sum()) for r in reqs}
        assert len(lengths) == 3
        solo = [srv.predict(*r) for r in reqs]
        got = _run_direct_batch(srv, t_server._PendingRequest, reqs)
        for g, s in zip(got, solo):
            np.testing.assert_array_equal(g, s)
        if kw:
            ar = _vla_server()
            for g, r in zip(got, reqs):
                np.testing.assert_array_equal(g, ar.predict(*r))
    finally:
        srv.stop()


def test_openvla_oft_bucket_with_proprio():
    """OFT with proprio: each row of a bucket is its request's solo chunk
    (fp32, within 1e-5), its own proprio read."""
    srv = _vla_server(max_batch=4, oft=True, use_proprio=True, proprio_dim=7, chunk_len=2)
    try:
        rng = np.random.RandomState(4)
        reqs = [(*_vla_request(i, instr), rng.uniform(-1, 1, 7).tolist())
                for i, instr in enumerate(INSTRUCTIONS)]
        solo = [srv.predict(*r) for r in reqs]
        got = _run_direct_batch(srv, t_server._PendingRequest, reqs)
        for g, s in zip(got, solo):
            assert g.shape == (2, 7)
            np.testing.assert_allclose(g, s, atol=1e-5, rtol=0)
        assert not np.array_equal(got[0], got[1])
    finally:
        srv.stop()


def test_jax_and_port_openvla_buckets_agree_on_one_snapshot(tmp_path):
    """The same snapshot behind JAX's and the port's OpenVLA servers with
    max_batch 2: one bucket of 2 ragged prompts, the same answers."""
    from blurr_tpu.serving.openvla_server import OpenVLAActionServer as JServer
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec
    from tests.test_torch_openvla_checkpoint import write_snapshot

    write_snapshot(tmp_path, OpenVLASpec.tiny(), seed=6)
    reqs = [(*_vla_request(7, INSTRUCTIONS[0]), None), (*_vla_request(8, INSTRUCTIONS[2]), None)]
    ours = _vla_server(str(tmp_path), unnorm_key="bridge_orig", max_batch=2)
    theirs = JServer(str(tmp_path), unnorm_key="bridge_orig", use_bf16=False, max_batch=2)
    try:
        want = _run_direct_batch(theirs, j_server._PendingRequest, reqs)
        got = _run_direct_batch(ours, t_server._PendingRequest, reqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    finally:
        ours.stop()
        theirs.stop()


def test_openvla_batcher_over_tcp():
    """4 concurrent clients on a batching OpenVLA server: each answer is
    its request's solo answer; the stats count the batches."""
    srv = _vla_server(max_batch=4, batch_window_ms=50.0)
    solo_srv = _vla_server()
    thread = _serve(srv)
    results = {}

    def hit(i):
        with PortActionClient(port=srv.port) as c:
            results[i] = c.predict(*_vla_request(i, INSTRUCTIONS[i % 3]), [0.0] * 7)

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        stats = srv.stats()
    finally:
        _stop(srv, thread)
    for i, r in results.items():
        np.testing.assert_array_equal(r, solo_srv.predict(*_vla_request(i, INSTRUCTIONS[i % 3]),
                                                          None))
    assert len(results) == 4 and stats["requests_total"] == 4
    assert stats["live_slots_total"] == 4 and stats["batches_total"] <= 4

