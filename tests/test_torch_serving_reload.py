"""Hot reload in the port's servers (``ActionServer.reload_checkpoint``, the
``reload`` message, ``ActionClient.reload``, ``scripts/serve_ctl_torch.py``)
on the CPU, against JAX's ``reload_checkpoint``.

Checkpoints are ``.pt`` files of tiny random weights written into
``tmp_path`` by the port's ``save_torch_checkpoint`` (JAX's server reads
them as the reference layout). Answers after a reload: the
same bits as a fresh port server on the new file at the same request index;
JAX's server after the same reload within fp32 atol 1e-4 (the same weights
and noise, sums in another order: ``tests/test_torch_checkpoint.py``).
Unlike JAX's, a reload after a failed ``drop_first`` (no live model) is
checked against the startup model's signature before it is served."""

import threading
import time

import numpy as np
import pytest
import torch

from blurr_tpu.serving import server as j_server
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.serving.client import ActionClient
from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer
from blurr_tpu_torch.serving.server import ActionServer
from tests.test_torch_serving_batch import _cfg, _requests, _serve, _stop, write_pt

TOL = 1e-4


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A and B: two tiny fp32 trees for the serving config; bad: a tree of
    another action_dim."""
    tmp = tmp_path_factory.mktemp("reload")
    bad_cfg = _cfg()
    bad_cfg["action_dim"] = 5
    return {"a": write_pt(_cfg(), 1, tmp / "a.pt"), "b": write_pt(_cfg(), 2, tmp / "b.pt"),
            "bad": write_pt(bad_cfg, 0, tmp / "bad.pt"), "missing": str(tmp / "missing.pt")}


def test_atomic_reload_serves_the_new_weights(ckpts):
    """Over the wire: the answers after a reload are a fresh server's on the
    new file, and JAX's after the same reload; an incompatible file is
    refused and the weights in service keep serving."""
    cfg = _cfg()
    req = _requests(1)[0]
    fresh = ActionServer(cfg, ckpts["b"], device="cpu", seed=7)
    want_b = [fresh.predict(*req) for _ in range(3)]
    jax_srv = j_server.ActionServer(cfg, ckpts["a"], seed=7)
    srv = ActionServer(cfg, ckpts["a"], device="cpu", seed=7)
    thread = _serve(srv)
    try:
        with ActionClient(port=srv.port) as client:
            before = client.predict(*req)
            np.testing.assert_allclose(before, jax_srv.predict(*req), atol=TOL, rtol=0)
            assert not np.array_equal(before, want_b[0])
            assert client.reload(ckpts["b"]) == {"reloaded": ckpts["b"], "drop_first": False}
            jax_srv.reload_checkpoint(ckpts["b"])
            after = client.predict(*req)
            np.testing.assert_array_equal(after, want_b[1])
            np.testing.assert_allclose(after, jax_srv.predict(*req), atol=TOL, rtol=0)
            stats = client.stats()
            assert stats["reloads_total"] == 1 and stats["checkpoint"] == ckpts["b"]
            with pytest.raises(RuntimeError, match="ValueError.*shape"):
                client.reload(ckpts["bad"])
            np.testing.assert_array_equal(client.predict(*req), want_b[2])
            stats = client.stats()
            assert stats["reloads_total"] == 1 and stats["checkpoint"] == ckpts["b"]
            assert stats["errors_total"] == 0
    finally:
        _stop(srv, thread)
        jax_srv.stop()


def test_drop_first_failure_then_recovery(ckpts):
    """drop_first frees the old model first; a failed drop_first leaves "no
    weights loaded" until a reload succeeds, by drop_first or atomically."""
    srv = ActionServer(_cfg(), "random", device="cpu", seed=7)
    req = _requests(1)[0]
    assert srv.reload_checkpoint(ckpts["a"], drop_first=True) == {
        "reloaded": ckpts["a"], "drop_first": True}
    assert srv.predict(*req).shape == (4, 7)
    with pytest.raises(FileNotFoundError):
        srv.reload_checkpoint(ckpts["missing"], drop_first=True)
    assert srv.model is None and "FAILED" in srv.stats()["checkpoint"]
    with pytest.raises(RuntimeError, match="no weights loaded"):
        srv.predict(*req)
    srv.reload_checkpoint(ckpts["b"], drop_first=True)
    assert srv.predict(*req).shape == (4, 7)
    with pytest.raises(FileNotFoundError):
        srv.reload_checkpoint(ckpts["missing"], drop_first=True)
    assert srv.reload_checkpoint(ckpts["b"])["drop_first"] is False
    fresh = ActionServer(_cfg(), ckpts["b"], device="cpu", seed=7)
    fresh._req_idx = srv._req_idx
    np.testing.assert_array_equal(srv.predict(*req), fresh.predict(*req))
    stats = srv.stats()
    assert stats["reloads_total"] == 3 and stats["checkpoint"] == ckpts["b"]
    assert stats["errors_total"] == 1


def test_recovery_refuses_a_mismatched_model(ckpts, monkeypatch):
    """With no live model (a failed drop_first), a reload is still held to
    the startup model: a file of another shape and a model of another
    quantization are refused, and the server stays without weights until a
    matching reload. With a live model the same refusal keeps it serving."""
    cfg = _cfg()
    srv = ActionServer(cfg, ckpts["a"], device="cpu", seed=7)
    req = _requests(1)[0]
    with pytest.raises(FileNotFoundError):
        srv.reload_checkpoint(ckpts["missing"], drop_first=True)
    with pytest.raises(ValueError, match="shape"):
        srv.reload_checkpoint(ckpts["bad"])
    assert srv.model is None

    def int8_model(path):
        qcfg = _cfg()
        qcfg["action_quantization"] = {"mode": "int8"}
        return PiZero(qcfg, device="cpu", dtype=torch.float32).enable_action_quantization()

    monkeypatch.setattr(srv, "_build_model", int8_model)
    for drop_first in (False, True):
        with pytest.raises(ValueError, match="structurally incompatible"):
            srv.reload_checkpoint(ckpts["b"], drop_first=drop_first)
        with pytest.raises(RuntimeError, match="no weights loaded"):
            srv.predict(*req)
    monkeypatch.undo()
    srv.reload_checkpoint(ckpts["b"])
    served = srv.predict(*req)
    monkeypatch.setattr(srv, "_build_model", int8_model)
    with pytest.raises(ValueError, match="structurally incompatible"):
        srv.reload_checkpoint(ckpts["a"])
    assert srv.predict(*req).shape == served.shape
    assert srv.stats()["checkpoint"] == ckpts["b"] and srv.stats()["reloads_total"] == 1


def test_drop_first_stalls_requests_in_flight():
    """A request racing a drop_first reload waits on the lock until the new
    model lands; it does not see the model missing and fail."""
    srv = ActionServer(_cfg(), "random", device="cpu", seed=0)
    req = _requests(1)[0]
    srv.predict(*req)
    build = srv._build_model
    in_reload = threading.Event()

    def slow_build(path):
        in_reload.set()
        time.sleep(0.8)  # the lock held, the model None
        return build(path)

    srv._build_model = slow_build
    results, errors = [], []

    def reload():
        try:
            srv.reload_checkpoint("random", drop_first=True)
        except Exception as exc:  # recorded for the assertion below
            errors.append(exc)

    def request():
        try:
            results.append(srv.predict(*req))
        except Exception as exc:  # recorded for the assertion below
            errors.append(exc)

    rt = threading.Thread(target=reload)
    rt.start()
    assert in_reload.wait(10)
    qt = threading.Thread(target=request)
    qt.start()
    rt.join(60)
    qt.join(60)
    assert not rt.is_alive() and not qt.is_alive()
    assert not errors, errors
    assert len(results) == 1 and results[0].shape == (4, 7)
    assert srv.stats()["reloads_total"] == 1


def test_reload_while_batches_run(ckpts):
    """A batching server reloaded twice while 3 clients send requests: no
    request fails, every answer is a finite chunk."""
    srv = ActionServer(_cfg(), ckpts["a"], device="cpu", seed=0, max_batch=4,
                       batch_window_ms=5.0)
    thread = _serve(srv)
    stop, answers, errors = threading.Event(), [], []

    def client(i):
        with ActionClient(port=srv.port) as c:
            while not stop.is_set():
                try:
                    answers.append(c.predict(*_requests(1, seed=i)[0]))
                except RuntimeError as exc:
                    errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for path in (ckpts["b"], ckpts["a"]):
            time.sleep(0.2)
            srv.reload_checkpoint(path)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        _stop(srv, thread)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert answers and all(a.shape == (4, 7) and np.isfinite(a).all() for a in answers)
    stats = srv.stats()
    assert stats["reloads_total"] == 2 and stats["errors_total"] == 0
    assert stats["checkpoint"] == ckpts["a"]


def test_serve_ctl_torch_cli(ckpts, capsys):
    """scripts/serve_ctl_torch.py drives stats and reload over the wire and
    prints the server's JSON; a refused reload prints the error and exits 1."""
    import importlib.util
    import json

    from blurr_tpu.paths import repo_root

    path = repo_root() / "scripts" / "serve_ctl_torch.py"
    spec = importlib.util.spec_from_file_location("serve_ctl_torch", path)
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    srv = ActionServer(_cfg(), ckpts["a"], device="cpu", seed=0)
    thread = _serve(srv)
    try:
        port = str(srv.port)
        assert ctl.main(["stats", "--port", port]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["reloads_total"] == 0 and st["checkpoint"] == ckpts["a"]
        assert ctl.main(["reload", ckpts["b"], "--port", port]) == 0
        assert json.loads(capsys.readouterr().out) == {"reloaded": ckpts["b"],
                                                       "drop_first": False}
        assert ctl.main(["reload", "random", "--drop-first", "--port", port]) == 0
        assert json.loads(capsys.readouterr().out)["drop_first"] is True
        assert ctl.main(["reload", ckpts["bad"], "--port", port]) == 1
        out = capsys.readouterr()
        assert out.out == "" and "ValueError" in out.err
        assert ctl.main(["stats", "--port", port]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["reloads_total"] == 2 and st["checkpoint"] == "random"
    finally:
        _stop(srv, thread)


def test_openvla_reload_names_m13(tmp_path):
    """The OpenVLA server hot-reloads a trained parameter tree (refused
    before the trainer was ported, ROADMAP M13) over the wire into a server
    started from another: the answers become the tree's; a structurally
    incompatible tree (rank-3 adapters) is
    refused with the server's message while the connection and the model
    keep serving."""
    from tests.test_torch_serving_openvla import trained_tree

    trained_tree(tmp_path / "b", seed=1)
    trained = trained_tree(tmp_path / "a", seed=2)
    trained_tree(tmp_path / "rank3", seed=3, rank=3)
    srv = OpenVLAActionServer("random", use_bf16=False, device="cpu",
                              checkpoint_path=str(tmp_path / "b"))
    thread = _serve(srv)
    try:
        img = np.zeros((28, 28, 3), np.uint8)
        with ActionClient(port=srv.port) as client:
            before = client.predict(img, "pick up the carrot", [0.0] * 7)
            assert client.reload(str(tmp_path / "a")) == {"reloaded": str(tmp_path / "a"),
                                                          "drop_first": False}
            after = client.predict(img, "pick up the carrot", [0.0] * 7)
            with pytest.raises(RuntimeError, match="ValueError.*structurally incompatible"):
                client.reload(str(tmp_path / "rank3"), drop_first=True)
            with pytest.raises(RuntimeError, match="no weights loaded"):
                client.predict(img, "pick up the carrot", [0.0] * 7)
            client.reload(str(tmp_path / "a"), drop_first=True)
            np.testing.assert_array_equal(client.predict(img, "pick up the carrot", [0.0] * 7),
                                          after)
            stats = client.stats()
    finally:
        _stop(srv, thread)
    ids, am, px = srv._prepare(img, "pick up the carrot")
    want = trained.detokenize_actions(trained.predict_action_tokens_ragged(ids, px, am).numpy())
    np.testing.assert_array_equal(after, want.astype(np.float32)[0])
    # a random tiny model answers the edge bins, so the weights tell the
    # trees apart
    served, mine = srv.model.state_dict(), trained.state_dict()
    assert served.keys() == mine.keys() and all(torch.equal(served[k], mine[k]) for k in mine)
    assert before.shape == after.shape
    assert stats["reloads_total"] == 2 and stats["checkpoint"] == str(tmp_path / "a")
