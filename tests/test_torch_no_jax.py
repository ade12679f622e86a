"""The port never imports JAX nor anything of ``blurr_tpu``.

In a subprocess where both ``import jax`` and ``import blurr_tpu`` fail:
import blurr_tpu_torch, load a bundled config, run a tiny random
infer_action on the CPU (and its naive step with an adaLN-Zero expert),
build the port's ActionServer (bf16, w4a8, int8 with the int8 KV cache and
dynamic batching, the baseline preset's naive step, and from a .pt
checkpoint it wrote) and drive it through the port's own ActionClient and
``scripts/serve_ctl_torch.py``'s reload, import the experiment modules,
resize an off-size frame on the native and the torch rungs, and run the eval
agent (serial with the async pipeline, and batched) and the eval CLI on the
fake env, run a tiny Pi-0 text generation and a tiny PaliGemma
``generate_fused``, write its weights as safetensors and load them back
with ``load_hf_model``, and run the text demo's random mode; then the
OpenVLA family: servers (bf16 and w4a8, AR and Jacobi, OFT with proprio)
driven through the port's client, an HF snapshot written and served, and
``scripts/serve_openvla_torch.py``'s server; the OpenVLA-family eval CLIs
on tiny random models, the streaming quantizer, the checkpoint checker on a
``.pt`` it writes, ``ModuleSpec`` and the action-accuracy metric. A
subprocess of its own serves a tensor-parallel (tp=2) tiny server on two
``gloo`` ranks through the port's client, runs ``main_rank_only`` and
trains ``--sp 2`` and ``--pp 2`` on two ranks each.
Then a static check: no ``.py``
file of the port (``parallel/mesh.py``, ``parallel/tensor_parallel.py``
and ``utils/decorator.py`` among them), nor ``chip_smoke.py`` or the
port's fifteen scripts, has an import whose top-level module is ``jax`` or
``blurr_tpu``. A second subprocess runs a QLoRA training step and a LoRA
run's export the same way, then the OpenVLA trainer (QLoRA w4a8 AR from a
sharded dataset written by ``models/openvla/data.py``, its PEFT adapter
merged back into a snapshot, and OFT), its --save-params tree served and
scored by the open-loop evaluator; then Pi-0's open-loop evaluator on a
sharded dataset, and GPTQ calibrated on its examples.
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
    # ops.quant, int8_matmul; dynamic batching, a reload by serve_ctl_torch
    srv = ActionServer(cfg, "random", device="cpu", max_batch=2)
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever,
                         kwargs={"port": 0, "ready_event": ready}, daemon=True)
    t.start()
    assert ready.wait(60)
    sys.path.insert(0, "scripts")
    import serve_ctl_torch
    assert serve_ctl_torch.main(["reload", "random", "--port", str(srv.port)]) == 0
    with ActionClient(port=srv.port) as client:
        act = client.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
        stats = client.stats()
        assert (stats["requests_total"], stats["batches_total"], stats["reloads_total"]) == (
            1, 1, 1)
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
    # the OpenVLA family: servers (bf16 and w4a8, AR and Jacobi, OFT) through
    # the port's client, and an HF snapshot written and served
    import serve_openvla_torch
    from blurr_tpu_torch.models.openvla.build import build_openvla
    from blurr_tpu_torch.models.openvla.checkpoint import save_openvla_snapshot
    from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer
    frame = np.zeros((28, 28, 3), np.uint8)
    for kw in ({}, {"quantization": "w4a8", "decode": "jacobi"},
               {"oft": True, "use_proprio": True, "proprio_dim": 7, "chunk_len": 2}):
        srv = OpenVLAActionServer("random", device="cpu", **kw)
        ready = threading.Event()
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"port": 0, "ready_event": ready}, daemon=True)
        t.start()
        assert ready.wait(60)
        with ActionClient(port=srv.port) as client:
            act = client.predict(frame, "pick", [0.1] * 7)
        srv.stop()
        t.join(30)
        assert act.shape == ((2, 7) if kw.get("oft") else (7,)) and np.isfinite(act).all()
    with tempfile.TemporaryDirectory() as tmp:  # an HF snapshot out and in
        model = build_openvla("random", device="cpu", dtype=torch.float32).model
        stats = {"bridge_orig": {"action": {"q01": [0.0] * 7, "q99": [1.0] * 7}}}
        save_openvla_snapshot(model, tmp, stats)
        srv = OpenVLAActionServer(tmp, unnorm_key="bridge_orig", use_bf16=False,
                                  device="cpu")
        ids = np.array([[1, 9, 29871]])
        px = np.random.RandomState(0).rand(1, 6, 28, 28).astype(np.float32)
        assert torch.equal(srv.model.predict_action_tokens(ids, px),
                           model.predict_action_tokens(ids, px))
        assert srv.predict(frame, "pick", [0.0] * 7).shape == (7,)
    srv = serve_openvla_torch.build_server(serve_openvla_torch.parse_args(
        ["--device", "cpu", "--decode", "jacobi"]))
    assert srv.predict(frame, "pick", [0.0] * 7).shape == (7,)
    # the OpenVLA-family eval CLIs (tiny random models), the streaming
    # quantizer, the checkpoint checker on a .pt it writes, ModuleSpec and
    # the action-accuracy metric
    import eval_hf_vla_simpler_torch
    import eval_prismatic_vla_simpler_torch
    import verify_checkpoint_torch
    from blurr_tpu_torch.agent import hf_vla_utils
    from blurr_tpu_torch.models.openvla.llama import quantize_llama_streaming
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec
    from blurr_tpu_torch.utils.metric import get_action_accuracy
    from blurr_tpu_torch.utils.spec import ModuleSpec
    eval_prismatic_vla_simpler_torch.minivla_spec = (
        lambda vocab_size=32064: OpenVLASpec.tiny_minivla())
    with tempfile.TemporaryDirectory() as tmp:
        run = ["--task", "fake_widowx_carrot_on_plate", "--n-eval-episode", "1",
               "--max-steps", "2", "--device", "cpu"]
        eval_hf_vla_simpler_torch.main(["--model-id", "random", "--quantization", "w4a8",
                                        *run, "--log-dir", tmp + "/hf"])
        eval_prismatic_vla_simpler_torch.main(["--checkpoint", "random", *run,
                                               "--log-dir", tmp + "/prismatic"])
        for name in ("hf", "prismatic"):
            assert "Success rate:" in open(f"{tmp}/{name}/run.log").read()
        model = PiZero(load_config("config/eval/bridge_tiny.yaml"), device="cpu",
                       dtype=torch.float32)
        save_torch_checkpoint(model, tmp + "/pi0.pt")
        assert verify_checkpoint_torch.main(["--checkpoint", tmp + "/pi0.pt", "--config",
                                             "config/eval/bridge_tiny.yaml"]) == 0
    vla = build_openvla("random", device="cpu", dtype=torch.float32).model
    quantize_llama_streaming(vla.llama, "w8a8")
    assert vla.predict_action_tokens(ids[:, :4], px).shape == (1, 7)
    assert hf_vla_utils.bridge_action_to_simpler(np.zeros(7)).shape == (7,)
    fn = ModuleSpec.instantiate(ModuleSpec.create(get_action_accuracy))
    assert fn(torch.zeros(1, 2, 7), torch.zeros(1, 2, 7)).tolist() == [1.0, 1.0]
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


PARALLEL_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["blurr_tpu"] = None
    import tempfile
    import threading
    import numpy as np
    from blurr_tpu_torch.parallel import mesh, tensor_parallel  # noqa: F401
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.client import ActionClient
    from blurr_tpu_torch.serving.server import ActionServer
    from blurr_tpu_torch.utils.decorator import main_rank_only

    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "blurr")
    size = cfg["vision"]["config"]["image_size"]
    with tempfile.TemporaryDirectory() as tmp:
        srv = ActionServer(cfg, "random", device="cpu", tp=2,
                           init_method=f"file://{tmp}/store")
        ready = threading.Event()
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"port": 0, "ready_event": ready}, daemon=True)
        t.start()
        assert ready.wait(60)
        with ActionClient(port=srv.port) as client:
            act = client.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
            assert client.stats()["tp"] == 2
        srv.stop()
        t.join(30)
    assert act.shape == (4, 7) and np.isfinite(act).all()
    assert main_rank_only(lambda: "ran")() == "ran"
    # sequence- and pipeline-parallel training, each on two spawned ranks
    sys.path.insert(0, "scripts")
    import train_pi0_flow_torch
    from blurr_tpu_torch.ops import ring_attention  # noqa: F401
    for config, flags in (("bridge_tiny", ["--sp", "2"]), ("bridge_tiny_pp", ["--pp", "2"])):
        run = train_pi0_flow_torch.main([
            "--device", "cpu", "--config", f"config/eval/{config}.yaml", "--steps", "1",
            "--train-scope", "action_expert", *flags])
        assert len(run.ranks) == 2 and run.ranks[0]["losses"] == run.ranks[1]["losses"]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "blurr_tpu"))
    assert all(sys.modules[m] is None for m in loaded), loaded
    print("NO_JAX_PARALLEL_OK")
    """
)


def test_parallel_serving_runs_without_jax_or_blurr_tpu():
    """A tensor-parallel (tp=2) tiny server, its second rank a spawned
    process, through the port's client, ``main_rank_only``, and the trainer
    at ``--sp 2`` and ``--pp 2`` (ring attention imported), with ``jax``
    and ``blurr_tpu`` unimportable in rank 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE")}
    proc = subprocess.run(
        [sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_PARALLEL_OK" in proc.stdout


TRAIN_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["blurr_tpu"] = None
    sys.path.insert(0, "scripts")
    import tempfile
    import export_torch_checkpoint_torch
    import train_pi0_flow_torch
    with tempfile.TemporaryDirectory() as tmp:
        run = train_pi0_flow_torch.main([
            "--device", "cpu", "--config", "config/eval/bridge_tiny.yaml", "--steps", "1",
            "--lora-rank", "4", "--lora-quantize-base", "w4a8", "--dtype", "bf16",
            "--save-dir", tmp + "/q", "--save-state", tmp + "/s"])
        assert len(run.losses) == 1
        train_pi0_flow_torch.main([
            "--device", "cpu", "--config", "config/eval/bridge_tiny.yaml", "--steps", "1",
            "--lora-rank", "4", "--save-dir", tmp + "/l"])
        export_torch_checkpoint_torch.main([
            "--device", "cpu", "--config", "config/eval/bridge_tiny.yaml",
            "--params", tmp + "/l", "--out", tmp + "/l.pt"])
        # the OpenVLA trainer, its files served, scored and merged
        import eval_openloop_vla_torch
        import train_openvla_lora_torch
        from blurr_tpu_torch.models.openvla.build import build_openvla
        from blurr_tpu_torch.models.openvla.checkpoint import save_openvla_snapshot
        from blurr_tpu_torch.models.openvla.data import write_openvla_dataset
        from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer

        raw = train_openvla_lora_torch.synthetic_examples(4, 28, (7,), 0)
        write_openvla_dataset(tmp + "/d", raw["images"], raw["instructions"], raw["actions"])
        run = train_openvla_lora_torch.main([
            "--device", "cpu", "--steps", "1", "--lora-rank", "2", "--quantize-base", "w4a8",
            "--data", tmp + "/d", "--save-params", tmp + "/vp"])
        assert len(run.losses) == 1
        OpenVLAActionServer("random", checkpoint_path=tmp + "/vp", device="cpu")
        metrics = eval_openloop_vla_torch.main([
            "--device", "cpu", "--checkpoint", tmp + "/vp", "--data", tmp + "/d"])
        assert metrics["examples"] == 4
        save_openvla_snapshot(build_openvla("random", device="cpu").model, tmp + "/snap")
        train_openvla_lora_torch.main([
            "--device", "cpu", "--model-id", tmp + "/snap", "--steps", "1", "--lora-rank", "2",
            "--save-adapter", tmp + "/snap/lora_adapter"])
        build_openvla(tmp + "/snap", device="cpu")
        train_openvla_lora_torch.main([
            "--device", "cpu", "--steps", "1", "--lora-rank", "2", "--oft", "--use-proprio",
            "--save-adapter", tmp + "/o/lora_adapter"])
        # Pi-0's open-loop evaluator over a sharded dataset, and GPTQ
        # calibrated on its examples
        import numpy as np
        import torch
        import eval_openloop_torch
        from blurr_tpu_torch.benchmarks import load_cfg, load_model
        from blurr_tpu_torch.data import ShardedDataset, write_dataset
        from blurr_tpu_torch.experiments import quant_closed_loop  # noqa: F401
        from blurr_tpu_torch.models.pi0.calibrate import gptq_quantize_pi0

        cfg = load_cfg("config/eval/bridge_tiny.yaml")
        write_dataset(tmp + "/rec", eval_openloop_torch._synthetic_examples(cfg, 3, 0))
        metrics = eval_openloop_torch.main([
            "--device", "cpu", "--config", "config/eval/bridge_tiny.yaml", "--checkpoint",
            "random", "--batch-size", "2", "--data", tmp + "/rec"])
        assert metrics["examples"] == 3
        model = load_model(cfg, "random", torch.float32, "cpu")
        gptq_quantize_pi0(model, [ShardedDataset(tmp + "/rec").gather_batch(np.arange(2))],
                          num_flow_steps=1)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "blurr_tpu"))
    assert all(sys.modules[m] is None for m in loaded), loaded
    print("NO_JAX_TRAIN_OK")
    """
)


def test_training_runs_without_jax_or_blurr_tpu():
    """One bridge_tiny QLoRA w4a8 training step (its --save-dir and
    --save-state), a LoRA run exported to a .pt, the OpenVLA trainer's runs
    and files, and Pi-0's open-loop evaluation and GPTQ (the module
    docstring), with ``jax`` and ``blurr_tpu`` unimportable."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE")}
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_TRAIN_OK" in proc.stdout


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
    REPO_ROOT / "scripts" / "demo_paligemma_text_torch.py",
    REPO_ROOT / "scripts" / "serve_openvla_torch.py",
    REPO_ROOT / "scripts" / "serve_ctl_torch.py",
    REPO_ROOT / "scripts" / "eval_hf_vla_simpler_torch.py",
    REPO_ROOT / "scripts" / "eval_prismatic_vla_simpler_torch.py",
    REPO_ROOT / "scripts" / "verify_checkpoint_torch.py",
    REPO_ROOT / "scripts" / "train_pi0_flow_torch.py",
    REPO_ROOT / "scripts" / "export_torch_checkpoint_torch.py",
    REPO_ROOT / "scripts" / "time_quant_linear_torch.py",
    REPO_ROOT / "scripts" / "ablate_flash_fp32_torch.py",
    REPO_ROOT / "scripts" / "train_openvla_lora_torch.py",
    REPO_ROOT / "scripts" / "eval_openloop_vla_torch.py",
    REPO_ROOT / "scripts" / "eval_openloop_torch.py"]


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
