"""The port never imports JAX nor anything of ``blurr_tpu``.

In a subprocess where both ``import jax`` and ``import blurr_tpu`` fail:
import blurr_tpu_torch, load a bundled config, run a tiny random
infer_action on the CPU (and its naive step with an adaLN-Zero expert),
build the port's ActionServer (bf16, w4a8, int8 with the int8 KV cache, the
baseline preset's naive step, and from a .pt checkpoint it wrote) and drive
it through the port's own ActionClient, import the experiment modules,
resize an off-size frame on the native and the torch rungs, and run the eval
agent (serial with the async pipeline, and batched) and the eval CLI on the
fake env, run a tiny Pi-0 text generation and a tiny PaliGemma
``generate_fused``, write its weights as safetensors and load them back
with ``load_hf_model``, and run the text demo's random mode. Then a static
check: no ``.py`` file of the port, nor ``chip_smoke.py`` or the port's
three CLIs, has an import whose top-level module is ``jax`` or
``blurr_tpu``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    sys.modules["blurr_tpu"] = None  # and so does any `import blurr_tpu...`
    import copy
    import tempfile
    import threading
    import numpy as np
    import torch
    import blurr_tpu_torch
    from blurr_tpu_torch.experiments import bench_fused_ffn, bench_lowbit_matmul, lowbit
    from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.client import ActionClient
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge_tiny.yaml")
    assert cfg["joint"]["config"]["num_hidden_layers"] > 0  # defaults: resolved
    apply_preset(cfg, "blurr")
    model = PiZero(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    s = model.spec
    am = torch.zeros(1, s.max_image_text_tokens, dtype=torch.int32)
    am[:, :20] = 1
    ids = torch.full((1, s.max_image_text_tokens), s.image_token_index)
    ids[:, 16:] = 5
    size = cfg["vision"]["config"]["image_size"]
    act = model.infer_action(
        ids, am, torch.zeros(1, 3, size, size), torch.zeros(1, 1, 7),
        torch.randn(1, 4, 7, generator=torch.Generator().manual_seed(1)),
    )
    assert act.shape == (1, 4, 7) and torch.isfinite(act).all()
    srv = ActionServer(cfg, "random", device="cpu")
    with tempfile.TemporaryDirectory() as tmp:  # reference .pt out and in
        save_torch_checkpoint(srv.model, tmp + "/pi0.pt")
        ActionServer(cfg, tmp + "/pi0.pt", device="cpu")
    apply_preset(cfg, "baseline")
    cfg["num_inference_steps"] = 1
    srv = ActionServer(cfg, "random", device="cpu")  # the naive step
    act = srv.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
    assert act.shape == (4, 7) and np.isfinite(act).all()
    ada = copy.deepcopy(cfg)
    ada["action_expert_adaptive_mode"] = "adaLN-Zero"
    for mix in ("proprio", "action"):
        ada["joint"]["config"]["mixture"][mix]["adaptive_mode"] = "adaLN-Zero"
    model = PiZero(ada, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    act = model.infer_action_naive(
        ids, am, torch.zeros(1, 3, size, size), torch.zeros(1, 1, 7),
        torch.zeros(1, 4, 7),
    )
    assert act.shape == (1, 4, 7) and torch.isfinite(act).all()
    apply_preset(cfg, "blurr")
    cfg["vlm_quantization"] = {"mode": "w4a8", "include_vision": True}
    cfg["action_quantization"] = {"mode": "w4a8"}
    ActionServer(cfg, "random", device="cpu")  # quantizes: ops.quant, int4
    cfg["vlm_quantization"] = {"mode": None}
    cfg["action_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                  "cache_fp_weight": False}
    cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                              "dtype": "bfloat16"}
    srv = ActionServer(cfg, "random", device="cpu")  # ops.quant, int8_matmul
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever,
                         kwargs={"port": 0, "ready_event": ready}, daemon=True)
    t.start()
    assert ready.wait(60)
    with ActionClient(port=srv.port) as client:
        act = client.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
        assert client.stats()["requests_total"] == 1
    srv.stop()
    t.join(30)
    assert act.shape == (4, 7) and np.isfinite(act).all()
    # off-size frames: the resize ladder's native and torch rungs
    from blurr_tpu_torch import native
    from blurr_tpu_torch.utils import image
    image.cv2 = None
    frame = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
    assert native.available()
    assert image.lanczos_resize_uint8(frame, size, size).shape == (size, size, 3)
    native.available = lambda: False
    assert image._torch_rung(frame, size, size).shape == (size, size, 3)
    # the closed-loop agents and the eval CLI on the fake env
    from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent
    from blurr_tpu_torch.agent.eval_agent import EvalAgent
    sys.path.insert(0, "scripts")
    import eval_pi0_simpler_torch
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "blurr")
    cfg["num_inference_steps"] = 1
    cfg["env"]["task"] = "fake_widowx_carrot_on_plate"
    with tempfile.TemporaryDirectory() as tmp:
        cfg.update({"n_eval_episode": 1, "n_video": 0, "checkpoint_path": "random",
                    "log_dir": tmp, "async_pipeline": True, "act_steps": 2})
        assert EvalAgent(cfg, device="cpu").run() == 1.0
        cfg.update({"batch_envs": 2, "n_eval_episode": 2})
        assert BatchedEvalAgent(cfg, device="cpu").run() == 0.5
        eval_pi0_simpler_torch.main([
            "--task", "fake_widowx_carrot_on_plate", "--checkpoint", "random",
            "--config", "config/eval/bridge_tiny.yaml", "--n-eval-episode", "1",
            "--num-inference-steps", "1", "--device", "cpu", "--log-dir", tmp + "/cli"])
        assert "Success rate: 1.0" in open(tmp + "/cli/run.log").read()
    # the text path: Pi-0's text mode, PaliGemma, safetensors, the demo
    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.load import load_hf_model
    from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration
    from blurr_tpu_torch.models.pi0.checkpoint import paligemma_state_dict, save_safetensors
    import demo_paligemma_text_torch
    model = PiZero(load_config("config/eval/bridge_tiny.yaml"), device="cpu",
                   dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    logits, cache, n = model.infer_text_prefill(ids, torch.zeros(1, 3, size, size),
                                                ids.shape[1] + 2)
    tok, cache, n = model.infer_text_decode_step(logits[:, -1].argmax(-1), cache, n)
    assert tok.shape == (1,) and n == ids.shape[1] + 1
    pg = PaliGemmaForConditionalGeneration(
        PaliGemmaConfig(**demo_paligemma_text_torch.TINY_CONFIG), device="cpu")
    pg.init_params(torch.Generator().manual_seed(0))
    pg_ids = np.array([[260] * 4 + [5, 6, 7]])
    toks = pg.generate_fused(pg_ids, np.zeros((1, 3, 28, 28), np.float32), 3)
    assert toks.shape == (1, 3)
    with tempfile.TemporaryDirectory() as tmp:  # safetensors out and in
        save_safetensors(paligemma_state_dict(pg.embed_tokens, pg.vision_tower,
                                              pg.multi_modal_projector, pg.vlm),
                         tmp + "/model.safetensors")
        import json
        with open(tmp + "/config.json", "w") as f:
            json.dump(demo_paligemma_text_torch.TINY_CONFIG, f)
        back = load_hf_model(tmp, torch.float32, "cpu")
        assert all(torch.equal(p, q) for p, q in zip(back.parameters(), pg.parameters()))
    assert demo_paligemma_text_torch.main(["--device", "cpu", "--max-new-tokens", "2"]) == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "blurr_tpu"))
    assert all(sys.modules[m] is None for m in loaded), loaded
    print("NO_JAX_OK")
    """
)


def test_port_runs_without_jax_or_blurr_tpu():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE")
    }
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def _imported_top_levels(path: Path):
    """(line, top-level module) of every import statement in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


PORT_FILES = sorted((REPO_ROOT / "blurr_tpu_torch").rglob("*.py")) + [
    REPO_ROOT / "chip_smoke.py", REPO_ROOT / "scripts" / "eval_pi0_simpler_torch.py",
    REPO_ROOT / "scripts" / "serve_pi0_torch.py",
    REPO_ROOT / "scripts" / "demo_paligemma_text_torch.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_file_of_the_port_imports_jax_or_blurr_tpu(path):
    bad = [(line, mod) for line, mod in _imported_top_levels(path)
           if mod in ("jax", "jaxlib", "blurr_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_the_static_check_sees_the_imports():
    """It tells blurr_tpu from blurr_tpu_torch and sees nested imports."""
    src = REPO_ROOT / "tests" / "test_torch_experiments.py"
    mods = {mod for _, mod in _imported_top_levels(src)}
    assert {"jax", "blurr_tpu_torch", "experiments"} <= mods
    assert "blurr_tpu" not in {mod for _, mod in _imported_top_levels(
        REPO_ROOT / "blurr_tpu_torch" / "serving" / "server.py")}
    assert "blurr_tpu" in {mod for _, mod in _imported_top_levels(
        REPO_ROOT / "tests" / "test_torch_int4_matmul.py")}
