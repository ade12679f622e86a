"""The port's ActionServer (blurr_tpu_torch.serving) over a real socket on the
CPU, driven by the JAX package's unchanged ActionClient and by the port's own
copy of it; the port's copy of the wire protocol writes the JAX package's
bytes.

bridge_tiny.yaml, not tiny_pi0_cfg: the stub tokenizer emits ids up to 999,
past that config's vocab of 64 (torch's embedding raises on them).
"""

import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from blurr_tpu.paths import repo_root
from blurr_tpu.serving import server as j_server
from blurr_tpu.serving.client import ActionClient
from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
from blurr_tpu_torch.serving import protocol as t_protocol
from blurr_tpu_torch.serving.client import ActionClient as PortActionClient
from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear, W4A8Linear, W8A8Linear
from blurr_tpu_torch.presets import ALIASES, PRESETS, apply_preset, load_config
from blurr_tpu_torch.serving.server import ActionServer


@pytest.fixture(scope="module")
def server():
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")
    cfg["num_inference_steps"] = 2
    srv = ActionServer(cfg, "random", device="cpu", seed=0)
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
        daemon=True,
    )
    t.start()
    assert ready.wait(30)
    yield srv
    srv.stop()
    t.join(10)
    assert not t.is_alive()


def test_two_requests_roundtrip(server):
    size = server.cfg["vision"]["config"]["image_size"]
    image = np.random.RandomState(0).randint(0, 256, (size, size, 3), np.uint8)
    with ActionClient(port=server.port) as client:
        outs = [
            client.predict(image, "put the spoon on the towel", [0.1] * 7)
            for _ in range(2)
        ]
        stats = client.stats()
    for a in outs:
        assert a.shape == (4, 7)
        assert np.isfinite(a).all()
        assert (np.abs(a) <= 1.0).all()
    # per-request noise: the two answers to the same request differ
    assert not np.array_equal(outs[0], outs[1])
    assert stats["requests_total"] == 2
    assert stats["errors_total"] == 0
    assert stats["device"] == "cpu"


def test_the_port_client_drives_the_port_server(server):
    """The port's own ActionClient: the same answers as the JAX client's for
    the same request index, errors raised as RuntimeError."""
    size = server.cfg["vision"]["config"]["image_size"]
    image = np.random.RandomState(3).randint(0, 256, (size, size, 3), np.uint8)
    with PortActionClient(port=server.port) as client:
        before = client.stats()["requests_total"]
        out = client.predict(image, "put the spoon on the towel", [0.2] * 7)
        with pytest.raises(RuntimeError, match="proprio"):
            client.predict(image, "x", [0.0] * 3)
        assert client.stats()["requests_total"] == before + 1
    assert out.dtype == np.float32 and out.shape == (4, 7) and np.isfinite(out).all()


def test_send_msg_writes_jax_bytes():
    msg = {"instruction": "pick", "image": "AAEC", "image_shape": [1, 1, 3],
           "proprio": [0.25, -1.0], "kind": "stats", "nested": {"a": [1, 2.5]}}
    wire = []
    for send in (t_protocol.send_msg, j_server.send_msg):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            n = struct.unpack(">I", b.recv(4))[0]
            wire.append(b.recv(n, socket.MSG_WAITALL))
    assert wire[0] == wire[1]
    a, b = socket.socketpair()
    with a, b:
        j_server.send_msg(a, msg)
        assert t_protocol.recv_msg(b) == msg
        a.sendall(struct.pack(">I", 3) + b"{x}")
        with pytest.raises(t_protocol.ProtocolError) as bad:
            t_protocol.recv_msg(b)
        assert bad.value.recoverable
        a.sendall(struct.pack(">I", t_protocol.MAX_MSG_BYTES + 1))
        with pytest.raises(t_protocol.ProtocolError) as big:
            t_protocol.recv_msg(b)
        assert not big.value.recoverable
        a.close()
        assert t_protocol.recv_msg(b) is None
    assert t_protocol.MAX_MSG_BYTES == j_server.MAX_MSG_BYTES


def test_bad_requests_keep_the_connection(server):
    size = server.cfg["vision"]["config"]["image_size"]
    with ActionClient(port=server.port) as client:
        with pytest.raises(RuntimeError, match="proprio"):
            client.predict(np.zeros((size, size, 3), np.uint8), "x", [0.0] * 3)
        with pytest.raises(RuntimeError, match="HxWx3"):
            client.predict(np.zeros((size, size, 4), np.uint8), "x", [0.0] * 7)
        # an off-size frame is resized (utils/image.py) and answered
        off_size = client.predict(np.zeros((size + 4, size, 3), np.uint8), "x", [0.0] * 7)
        out = client.predict(np.zeros((size, size, 3), np.uint8), "x", [0.0] * 7)
    assert out.shape == (4, 7)
    assert off_size.shape == (4, 7) and np.isfinite(off_size).all()


def test_presets_equal_the_eval_cli_table():
    sys.path.insert(0, str(repo_root() / "scripts"))
    try:
        import eval_pi0_simpler
    finally:
        sys.path.remove(str(repo_root() / "scripts"))
    assert PRESETS == eval_pi0_simpler.PRESETS
    assert ALIASES == eval_pi0_simpler.ALIASES


def test_server_serves_the_naive_step_and_a_checkpoint(tmp_path):
    """The baseline and vanilla presets serve the naive step; a .pt path
    serves the weights it holds: the same answers as the server that drew
    them (fp32 weights written and read back exactly)."""
    cfg = load_config("config/eval/bridge_tiny.yaml")
    size = cfg["vision"]["config"]["image_size"]
    image = np.random.RandomState(3).randint(0, 256, (size, size, 3), np.uint8)
    for preset in ("baseline", "vanilla"):
        apply_preset(cfg, preset)
        cfg["num_inference_steps"] = 2
        srv = ActionServer(cfg, "random", device="cpu", seed=1)
        assert srv.prefix_cache is False
        cached = srv.model.infer_action
        srv.model.infer_action = None  # the naive step must not reach it
        out = srv.predict(image, "put the spoon on the towel", [0.1] * 7)
        assert out.shape == (4, 7) and np.isfinite(out).all()
        srv.model.infer_action = cached
    path = str(tmp_path / "pi0.pt")
    save_torch_checkpoint(srv.model, path)
    loaded = ActionServer(cfg, path, device="cpu", seed=1)
    assert loaded.stats()["checkpoint"] == path
    np.testing.assert_array_equal(
        loaded.predict(image, "put the spoon on the towel", [0.1] * 7), out)


def test_processor_takes_a_local_tokenizer_or_the_stub(tmp_path, caplog):
    """build_processor takes the tokenizer at a local pretrained_model_path
    (here a word-level one the test writes) and gives JAX's ids; with no
    files there it takes the stub and warns once, saying why."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from blurr_tpu.benchmarks import build_processor as j_build_processor
    from blurr_tpu_torch.models.pi0.processing import StubTokenizer, build_processor

    words = "<pad> <eos> <bos> <unk> put the spoon on towel".split()
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<bos>", eos_token="<eos>",
        pad_token="<pad>", unk_token="<unk>",
    ).save_pretrained(tmp_path)
    cfg = {"pretrained_model_path": str(tmp_path), "image_token_index": 50,
           "vision": {"config": {"num_image_tokens": 4}}, "max_seq_len": 12}
    port, jax_side = build_processor(cfg), j_build_processor(cfg)
    assert not isinstance(port.tokenizer, StubTokenizer)
    want = jax_side.tokenize(["put the spoon on the towel"])
    got = port.tokenize(["put the spoon on the towel"])
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    cfg["pretrained_model_path"] = str(tmp_path / "missing")
    with caplog.at_level("WARNING"):
        stub = build_processor(cfg)
    assert isinstance(stub.tokenizer, StubTokenizer)
    warned = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert len(warned) == 1 and "stub tokenizer" in warned[0] and "missing" in warned[0]


def _serve_script():
    import importlib.util

    path = repo_root() / "scripts" / "serve_pi0_torch.py"
    spec = importlib.util.spec_from_file_location("serve_pi0_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_device_defaults_to_cuda():
    """Parsed only: nothing is built or served."""
    script = _serve_script()
    assert script.parse_args([]).device == "cuda"
    assert script.parse_args(["--device", "cpu"]).device == "cpu"


def test_cli_requires_a_device():
    """With no card visible and no --device cpu, the CLI fails on its first
    CUDA call; it does not fall back to the CPU."""
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, str(repo_root() / "scripts" / "serve_pi0_torch.py"),
         "--config", "config/eval/bridge_tiny.yaml", "--port", "0"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_w4a8_server_answers_through_the_client():
    """bridge_tiny widths with the w4a8 preset's settings (bf16, one flow
    step, vlm + action w4a8, SigLIP w8a8): the server quantizes the weights
    it drew and answers through the unchanged ActionClient."""
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "blurr")
    cfg["vlm_quantization"] = {"mode": "w4a8", "include_vision": True}
    cfg["action_quantization"] = {"mode": "w4a8", "activation_clip": None}
    srv = ActionServer(cfg, "random", device="cpu", seed=0)
    model = srv.model
    assert isinstance(model.joint["vlm"].layers[0].gate_proj, W4A8Linear)
    assert isinstance(model.joint["proprio"].layers[0].q_proj, W4A8Linear)
    assert isinstance(model.vision_tower.layers[0].fc1, W8A8Linear)
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
        daemon=True,
    )
    t.start()
    try:
        assert ready.wait(30)
        size = cfg["vision"]["config"]["image_size"]
        image = np.random.RandomState(1).randint(0, 256, (size, size, 3), np.uint8)
        with ActionClient(port=srv.port) as client:
            out = client.predict(image, "put the spoon on the towel", [0.1] * 7)
            stats = client.stats()
    finally:
        srv.stop()
        t.join(10)
    assert not t.is_alive()
    assert out.shape == (4, 7) and np.isfinite(out).all() and (np.abs(out) <= 1).all()
    assert stats["requests_total"] == 1 and stats["errors_total"] == 0


def test_server_refuses_an_orbax_directory(tmp_path):
    """A directory is an orbax tree (JAX save_params), which the training
    port (ROADMAP M13) will read; a .pt file is what the port serves."""
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "blurr")
    with pytest.raises(NotImplementedError, match="M13"):
        ActionServer(cfg, str(tmp_path), device="cpu")


@pytest.mark.parametrize("cache_fp", [False, True])
def test_int8_server_answers_through_the_client(cache_fp):
    """bridge_tiny widths with the bridge_pool64_steps2 settings (bf16, 2
    flow steps, action int8 with its clip, the int8 KV cache): the server
    quantizes the weights it drew, to int8 {q, s} or to the cached bf16 copy
    the preset ships, and answers through the unchanged ActionClient."""
    preset = load_config("config/eval/bridge_pool64_steps2.yaml")
    cfg = load_config("config/eval/bridge_tiny.yaml")
    for key in ("use_bf16", "num_inference_steps", "final_action_clip_value",
                "action_quantization", "kv_quantization"):
        cfg[key] = preset[key]
    cfg["action_quantization"]["cache_fp_weight"] = cache_fp
    srv = ActionServer(cfg, "random", device="cpu", seed=0)
    model = srv.model
    kind = CachedFpLinear if cache_fp else Int8Linear
    assert isinstance(model.joint["proprio"].layers[0].down_proj, kind)
    assert isinstance(model.action_encoder_w2, kind)
    assert (model.spec.num_inference_steps, model.kv_quant_mode) == (2, "int8")
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve_forever, kwargs={"port": 0, "ready_event": ready},
        daemon=True,
    )
    t.start()
    try:
        assert ready.wait(30)
        size = cfg["vision"]["config"]["image_size"]
        image = np.random.RandomState(2).randint(0, 256, (size, size, 3), np.uint8)
        with ActionClient(port=srv.port) as client:
            out = client.predict(image, "put the spoon on the towel", [0.1] * 7)
            stats = client.stats()
    finally:
        srv.stop()
        t.join(10)
    assert not t.is_alive()
    assert out.shape == (4, 7) and np.isfinite(out).all() and (np.abs(out) <= 1).all()
    assert stats["requests_total"] == 1 and stats["errors_total"] == 0
