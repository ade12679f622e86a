"""The port's OpenVLA action server (``serving/openvla_server.py``) and its
CLI (``scripts/serve_openvla_torch.py``) on the CPU: a TCP round trip
through the port's ActionClient, answers equal to the model's own
``predict_action`` (AR, Jacobi, MiniVLA, w4a8), OFT with and without
proprio, ``unnorm_key``, the bounded token cache, the batching flags it
takes and the flags it refuses, and JAX's server and the port's on one
snapshot giving the same answers. Buckets of ragged requests:
``tests/test_torch_serving_batch.py``."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from blurr_tpu_torch.models.openvla.processing import build_prompt
from blurr_tpu_torch.serving.client import ActionClient
from blurr_tpu_torch.serving.openvla_server import TOKEN_CACHE_SIZE, OpenVLAActionServer

REPO_ROOT = Path(__file__).resolve().parents[1]


def _request(seed=0, instruction="pick up the carrot", size=28):
    image = np.random.RandomState(seed).randint(0, 256, (size, size, 3), np.uint8)
    return image, instruction, [0.0] * 7


def _server(model_id="random", **kw):
    return OpenVLAActionServer(model_id, use_bf16=False, device="cpu", **kw)


def _direct(srv, image, instruction):
    out = srv.processor(build_prompt(instruction), image)
    return srv.model.predict_action(out["input_ids"], out["pixel_values"], srv.unnorm_key)


def test_tcp_round_trip_through_the_port_client():
    srv = _server()
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
                         daemon=True)
    t.start()
    assert ready.wait(60)
    try:
        assert srv.warmup() > 0
        with ActionClient(port=srv.port) as client:
            img, instr, prop = _request()
            actions = client.predict(img, instr, prop)
            assert actions.shape == (7,) and np.all(np.abs(actions) <= 1.0)
            np.testing.assert_array_equal(client.predict(img, instr, prop), actions)
            off = client.predict(_request(1, size=40)[0], instr, prop)  # resized first
            assert off.shape == (7,)
            with pytest.raises(RuntimeError, match="HxWx3"):
                client.predict(np.zeros((28, 28, 4), np.uint8), instr, prop)
            stats = client.stats()
        assert stats["requests_total"] == 3 and stats["errors_total"] == 1
        assert stats["device"] == "cpu" and stats["checkpoint"] == "random"
    finally:
        srv.stop()
        t.join(30)


@pytest.mark.parametrize("model_id,kw", [
    ("random", {}),
    ("random", {"decode": "jacobi"}),
    ("random", {"quantization": "w4a8"}),
    ("random-minivla-tiny", {}),
    ("random-minivla-tiny", {"quantization": "w8a8", "decode": "jacobi"}),
])
def test_predict_equals_the_model(model_id, kw):
    """The served path (prompt right-padded to max_text_tokens, masked
    decode) answers what the model's predict_action gives the unpadded
    prompt."""
    srv = _server(model_id, **kw)
    for seed, instr in ((1, "pick up the carrot"), (2, "move the very shiny spoon left")):
        img, _, prop = _request(seed, instr)
        np.testing.assert_array_equal(srv.predict(img, instr, prop),
                                      np.asarray(_direct(srv, img, instr), np.float32))


def test_jacobi_server_answers_the_ar_server():
    ar, jac = _server(), _server(decode="jacobi")
    img, instr, prop = _request(3)
    np.testing.assert_array_equal(jac.predict(img, instr, prop), ar.predict(img, instr, prop))


def test_oft_requires_proprio_and_returns_chunks():
    srv = _server(oft=True, use_proprio=True, proprio_dim=7, chunk_len=4)
    img, instr, prop = _request(4)
    out = srv.predict(img, instr, [0.3] * 7)
    assert out.shape == (4, 7) and np.isfinite(out).all()
    ids, am, px, pr = srv._prepare(img, instr, [0.3] * 7)
    ref = srv.model.predict_action_continuous(ids, px, pr, attn_valid=am)[0].numpy()
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="proprio field is required"):
        srv.predict(img, instr, None)
    with pytest.raises(ValueError, match="server expects 7"):
        srv.predict(img, instr, [0.0] * 3)
    plain = _server(oft=True, chunk_len=2)  # no proprio: the field is ignored
    assert plain.predict(img, instr, None).shape == (2, 7)


def test_unnorm_key_is_checked_and_applied(tmp_path):
    from tests.test_torch_openvla_checkpoint import STATS, write_snapshot
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec

    with pytest.raises(ValueError, match="not in the model's norm stats"):
        _server(unnorm_key="bridge_orig")
    write_snapshot(tmp_path, OpenVLASpec.tiny())
    norm = _server(str(tmp_path))
    srv = _server(str(tmp_path), unnorm_key="bridge_orig")
    img, instr, prop = _request(5)
    out, raw = srv.predict(img, instr, prop), norm.predict(img, instr, prop)
    q01, q99 = (np.asarray(STATS["bridge_orig"]["action"][k]) for k in ("q01", "q99"))
    expected = np.where(np.arange(7) < 6, 0.5 * (raw + 1) * (q99 - q01) + q01, raw)
    np.testing.assert_allclose(out, expected, rtol=1e-6)
    np.testing.assert_array_equal(out, np.asarray(_direct(srv, img, instr), np.float32))


def test_token_cache_is_bounded():
    srv = _server()
    img = _request()[0]
    for i in range(TOKEN_CACHE_SIZE + 3):
        srv._prepare(img, f"task {i}")
    assert len(srv._tok_cache) == TOKEN_CACHE_SIZE
    assert "task 0" not in srv._tok_cache and f"task {TOKEN_CACHE_SIZE + 2}" in srv._tok_cache


@pytest.mark.parametrize("kw,match", [
    ({"dp": 3, "max_batch": 4}, "power of 2"), ({"dp": 2}, "max_batch >= dp"),
])
def test_refused_flags_name_their_milestone(kw, match):
    """The data-parallel checks refuse before any rank is spawned (tp / dp
    themselves are ported: tests/test_torch_parallel_serving.py)."""
    with pytest.raises(ValueError, match=match):
        _server(**kw)


def trained_tree(path, seed=0, quant=None, oft=False, rank=2):
    """A parameter tree as the trainer's --save-params writes it: a random
    tiny model (its LLM drawn ``quant``), rank-``rank`` LoRA on q and v with
    B non-zero. Returns the model."""
    from blurr_tpu_torch.models.openvla.build import build_openvla
    from blurr_tpu_torch.models.pi0.checkpoint import save_params
    from blurr_tpu_torch.ops.lora import LoRALinear, inject_lora_tree

    model = build_openvla("random", device="cpu", dtype=torch.float32, quantization=quant,
                          memory_safe_quant_init=True, oft=oft, chunk_len=2, seed=seed).model
    g = torch.Generator().manual_seed(seed)
    inject_lora_tree(model.llama, g, rank, ("q_w", "v_w"))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRALinear):
                m.lora_b.normal_(0.0, 0.5, generator=g)
    save_params(model, str(path))
    return model


@pytest.mark.parametrize("quant", [None, "w4a8"])
def test_checkpoint_path_serves_a_trained_tree(tmp_path, quant):
    """checkpoint_path: the tree's weights, its adapters rebuilt over its
    bases, answered as the trained model answers; a quantized tree refuses
    quantization and a LoRA tree post-training quantization (JAX's
    messages)."""
    from blurr_tpu_torch.ops.lora import LoRALinear

    model = trained_tree(tmp_path / "params", seed=5, quant=quant)
    srv = _server(checkpoint_path=str(tmp_path / "params"))
    q = srv.model.llama.layers[0].q_proj
    assert isinstance(q, LoRALinear) and type(q.base) is type(model.llama.layers[0].q_proj.base)
    img, instr, _ = _request()
    ids, am, px = srv._prepare(img, instr)
    np.testing.assert_array_equal(
        srv._post(srv._step(ids, am, px)),
        model.detokenize_actions(model.predict_action_tokens_ragged(ids, px, am).numpy())
        .astype(np.float32))
    assert srv.stats()["checkpoint"] == str(tmp_path / "params")
    match = "already carries a quantized LLM" if quant else "carries LoRA factor dicts"
    with pytest.raises(ValueError, match=match):
        _server(checkpoint_path=str(tmp_path / "params"), quantization="w8a8")


@pytest.mark.parametrize("kw", [
    {"max_batch": 2}, {"max_batch": 2, "max_queue": 4},
    {"max_batch": 3, "bucket_mode": "max"}, {"max_batch": 2, "batch_window_ms": 25.0},
])
def test_batching_flags_serve(kw):
    """The flags of dynamic batching build a server that answers what the
    single-request server answers, and report themselves in stats."""
    srv, solo = _server(**kw), _server()
    try:
        img, instr, prop = _request(9)
        np.testing.assert_array_equal(srv.predict(img, instr, prop),
                                      solo.predict(img, instr, prop))
        stats = srv.stats()
        assert stats["max_batch"] == kw["max_batch"] and stats["batches_total"] == 1
        assert stats["bucket_mode"] == kw.get("bucket_mode", "pow2")
        assert srv.max_queue == kw.get("max_queue", 0)
        assert srv.batch_window_s == kw.get("batch_window_ms", 2.0) / 1000.0
    finally:
        srv.stop()


def test_seed_draws_the_random_weights():
    """A random id's weights come from ``seed``: the same seed, the same
    weights; another, others."""
    a, b, c = _server(seed=3), _server(seed=3), _server(seed=4)
    wa, wb, wc = (s.model.llama.embed_tokens for s in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


def test_unknown_decode_is_an_error():
    with pytest.raises(ValueError, match="decode"):
        _server(decode="beam")


def test_cli_builds_the_server_and_refuses_what_the_server_refuses(tmp_path):
    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    import serve_openvla_torch

    args = serve_openvla_torch.parse_args(
        ["--device", "cpu", "--model-id", "random", "--no-bf16", "--oft", "--chunk-len", "2"])
    assert serve_openvla_torch.parse_args([]).device == "cuda"
    srv = serve_openvla_torch.build_server(args)
    assert srv.device == torch.device("cpu") and srv.dtype == torch.float32 and srv.oft
    batched = serve_openvla_torch.build_server(serve_openvla_torch.parse_args(
        ["--device", "cpu", "--max-batch", "4", "--batch-window-ms", "5", "--bucket-mode",
         "max", "--max-queue", "3"]))
    try:
        assert (batched.max_batch, batched.batch_window_s, batched.bucket_mode,
                batched.max_queue) == (4, 0.005, "max", 3)
    finally:
        batched.stop()
    # --dp reaches the server, whose checks run before any rank is spawned
    with pytest.raises(ValueError, match="max_batch >= dp"):
        serve_openvla_torch.build_server(serve_openvla_torch.parse_args(
            ["--device", "cpu", "--dp", "2"]))
    # --checkpoint serves a trained tree (refused before the trainer was
    # ported); a directory that is not one is refused
    trained_tree(tmp_path / "params")
    srv = serve_openvla_torch.build_server(serve_openvla_torch.parse_args(
        ["--device", "cpu", "--no-bf16", "--checkpoint", str(tmp_path / "params")]))
    assert type(srv.model.llama.layers[0].v_proj).__name__ == "LoRALinear"
    with pytest.raises(ValueError, match="not a parameter tree"):
        serve_openvla_torch.build_server(serve_openvla_torch.parse_args(
            ["--device", "cpu", "--checkpoint", str(tmp_path)]))
    # scripts/serve_pi0_torch.py: the same batching flags, JAX's defaults
    from tests.test_torch_serving import _serve_script

    pi0 = _serve_script()
    defaults = pi0.parse_args([])
    assert (defaults.max_batch, defaults.batch_window_ms, defaults.bucket_mode,
            defaults.max_queue, defaults.tp, defaults.dp) == (1, 2.0, "pow2", 0, 1, 1)
    tiny = ["--config", "config/eval/bridge_tiny.yaml", "--device", "cpu"]
    srv = pi0.build_server(pi0.parse_args(tiny + [
        "--max-batch", "4", "--batch-window-ms", "5", "--bucket-mode", "max",
        "--max-queue", "3"]))
    try:
        assert (srv.max_batch, srv.batch_window_s, srv.bucket_mode, srv.max_queue) == (
            4, 0.005, "max", 3)
        assert srv._buckets() == [4] and srv.device == torch.device("cpu")
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="power of 2"):
        pi0.build_server(pi0.parse_args(tiny + ["--dp", "3", "--max-batch", "4"]))


def test_jax_and_port_servers_answer_alike_on_one_snapshot(tmp_path):
    """The same snapshot behind JAX's OpenVLAActionServer and the port's, in
    fp32: the same answers, unnormalized, AR and Jacobi."""
    from blurr_tpu.serving.openvla_server import OpenVLAActionServer as JServer
    from tests.test_torch_openvla_checkpoint import write_snapshot
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec

    write_snapshot(tmp_path, OpenVLASpec.tiny(), seed=6)
    for kw in ({}, {"decode": "jacobi"}):
        ours = _server(str(tmp_path), unnorm_key="bridge_orig", **kw)
        theirs = JServer(str(tmp_path), unnorm_key="bridge_orig", use_bf16=False, **kw)
        for seed in (7, 8):
            img, instr, prop = _request(seed, f"put the cup {seed} away")
            np.testing.assert_array_equal(ours.predict(img, instr, prop),
                                          theirs.predict(img, instr, prop))
