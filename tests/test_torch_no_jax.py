"""The port never imports JAX: in a subprocess where ``import jax`` fails,
import blurr_tpu_torch, run a tiny random infer_action on the CPU and build
the port's ActionServer, bf16, w4a8, and int8 with the int8 KV cache."""

import os
import subprocess
import sys
import textwrap

from blurr_tpu.paths import repo_root

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import numpy as np
    import torch
    import blurr_tpu_torch
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge_tiny.yaml")
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
    ActionServer(cfg, "random", device="cpu")
    cfg["vlm_quantization"] = {"mode": "w4a8", "include_vision": True}
    cfg["action_quantization"] = {"mode": "w4a8"}
    ActionServer(cfg, "random", device="cpu")  # quantizes: ops.quant, int4
    cfg["vlm_quantization"] = {"mode": None}
    cfg["action_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                  "cache_fp_weight": False}
    cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                              "dtype": "bfloat16"}
    srv = ActionServer(cfg, "random", device="cpu")  # ops.quant, int8_matmul
    act = srv.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
    assert act.shape == (4, 7) and np.isfinite(act).all()
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert all(sys.modules[m] is None for m in loaded), loaded
    print("NO_JAX_OK")
    """
)


def test_port_runs_without_jax():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE")
    }
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=repo_root(), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
