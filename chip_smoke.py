#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: its main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
1. probe   - the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
             requires compute capability 9.0 (Hopper).
2. build   - builds every kernel of the path from csrc/ with nvcc for sm_90a.
3. kernel  - each kernel against its plain PyTorch version on the card at
             the shapes the path gives it (fp32 at 2e-4 with TF32 off; bf16
             against the plain version in fp32 at 2e-2), then both timed
             with CUDA events at the Pi-0 prefill shape.
4. serve   - the port's ActionServer at the full bridge.yaml width with the
             blurr preset (bf16, prefix KV cache, one flow step) and
             joint.config.use_flash_attn set, random weights drawn on the
             card; 3 requests through blurr_tpu.serving.ActionClient. Each
             answer must be a finite [4, 7] chunk in [-1, 1], and the flash
             kernel must have launched exactly 17 times per control step
             (18 layers, the last computes only K/V).
5. model   - the same weights and inputs through one control step with the
             kernel and with the plain attention; the actions must agree.
6. small   - a small fp32 model (bridge_tiny widths, an 80-token prefix so
             the prefill takes the kernel) on the card against the same
             weights on the CPU, where the port runs its plain versions
             (the CPU tests hold those against the JAX package).
Then one JSON line of the kernels (launches in the served run, errors and
times measured here), and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX and builds everything from the checkout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))
# the port and this script must not touch JAX: make any import of it fail
sys.modules["jax"] = None
for _var in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE"):
    os.environ.pop(_var, None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FP32_TOL = 2e-4  # fp32 sums in another order (TF32 off)
BF16_TOL = 2e-2  # bf16 output rounding against the fp32 plain version
# kernel vs plain attention through the whole bf16 control step: the two
# round P@V differently (fp32 P in the kernel, bf16 P in the plain path) in
# each of 17 layers of a random-weight model; 5e-2 is ~13 bf16 ulps at 1.0
MODEL_TOL = 5e-2
# fp32 on the card (kernel, cuBLAS with TF32 off) against fp32 on the CPU:
# the same formulas summed in another order through 10 flow steps
SMALL_TOL = 1e-4
N_REQUESTS = 3
PI0_SHAPE = (1, 8, 1, 277, 277, 256)  # b, nh, kvh, sq, skv, d
KERNEL_SHAPES = [
    PI0_SHAPE,                  # the joint prefill, pad rows fully masked
    (2, 4, 2, 100, 150, 64),   # ragged GQA
    (1, 4, 1, 64, 64, 32),     # smallest head_dim
]


def log(msg: str) -> None:
    print(msg, flush=True)


def probe() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from blurr_tpu_torch.ops.kernels import find_nvcc

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {smi}")
    log(f"probe: device={name} capability={cap} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc={find_nvcc()} "
        f"count={torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    return name


def build() -> None:
    from blurr_tpu_torch.ops import kernels

    t0 = time.monotonic()
    path = kernels.build("flash_attention")
    kernels.load("flash_attention")
    log(f"build: flash_attention in {time.monotonic() - t0:.2f} s -> "
        f"{path.relative_to(REPO_ROOT)}")
    for line in kernels.build_log("flash_attention").splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: ptxas {line.strip()}")


def _attention_inputs(shape, device):
    b, nh, kvh, sq, skv, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, nh, sq, d, generator=g, device=device) * 0.3
    k = torch.randn(b, kvh, skv, d, generator=g, device=device) * 0.3
    v = torch.randn(b, kvh, skv, d, generator=g, device=device)
    if shape == PI0_SHAPE:
        from blurr_tpu_torch.ops.masks import pi0_prefix_mask

        # 266 valid image/text tokens of 276: 10 pad rows fully masked
        am = torch.zeros(b, sq - 1, dtype=torch.int32, device=device)
        am[:, :266] = 1
        mask = pi0_prefix_mask(am, sq - 1, 1)
    else:
        mask = torch.rand(b, sq, skv, generator=g, device=device) > 0.3
        mask[:, :, 0] = True
    return q, k, v, mask


def _time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_vs_plain(device) -> dict:
    from blurr_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for shape in KERNEL_SHAPES:
        q, k, v, mask = _attention_inputs(shape, device)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            out = flash_attention(qc, kc, vc, mask)
            ref = flash_attention_reference(qc.float(), kc.float(), vc.float(), mask)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
            err = (out.float() - ref).abs().max().item()
            torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
            errs[(shape, dtype)] = err
            log(f"kernel: flash_attention {shape} {str(dtype)[6:]} "
                f"max_abs_err={err:.3e} (tol {tol:g})")
    q, k, v, mask = _attention_inputs(PI0_SHAPE, device)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
        kern = _time_ms(lambda: flash_attention(qc, kc, vc, mask))
        plain = _time_ms(lambda: flash_attention_reference(qc, kc, vc, mask))
        kern2 = _time_ms(lambda: flash_attention(qc, kc, vc, mask))
        times[dtype] = (min(kern, kern2), plain)
        log(f"kernel: time at {PI0_SHAPE} {str(dtype)[6:]}: kernel "
            f"{kern:.4f}/{kern2:.4f} ms, plain {plain:.4f} ms (CUDA events, "
            "50 launches each)")
    return {
        "max_abs_err": errs[(PI0_SHAPE, torch.bfloat16)],
        "ms": times[torch.bfloat16][0],
        "plain_ms": times[torch.bfloat16][1],
    }


def served_control_steps(device):
    from blurr_tpu.serving.client import ActionClient
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serve: bridge.yaml blurr preset, {n_params / 1e9:.3f} B params "
        f"{server.dtype} drawn on the card in {time.monotonic() - t0:.2f} s")
    ready = threading.Event()
    thread = threading.Thread(
        target=server.serve_forever, kwargs={"port": 0, "ready_event": ready},
        daemon=True,
    )
    thread.start()
    try:
        if not ready.wait(60):
            raise RuntimeError("server did not start listening")
        log(f"serve: warmup {server.warmup():.2f} s")
        size = cfg["vision"]["config"]["image_size"]
        rng = np.random.RandomState(0)
        image = rng.randint(0, 256, (size, size, 3), np.uint8)
        proprio = rng.uniform(-1, 1, 7).tolist()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        latencies, actions = [], []
        with ActionClient(port=server.port) as client:
            for _ in range(N_REQUESTS):
                t = time.monotonic()
                actions.append(client.predict(image, "put the spoon on the towel", proprio))
                latencies.append((time.monotonic() - t) * 1000.0)
            stats = client.stats()
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
        thread.join(30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    for a in actions:
        if a.shape != (4, 7) or not np.isfinite(a).all() or np.abs(a).max() > 1.0:
            raise RuntimeError(f"bad action chunk {a.shape}: {a}")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    expected = (n_layers - 1) * stats["requests_total"]
    log(f"serve: {stats['requests_total']} control steps, latency ms per "
        f"request (client) {[round(x, 3) for x in latencies]}, server p50 "
        f"{stats.get('latency_ms_p50')} ms")
    log(f"serve: flash_attention launches {launches} (expected {expected} = "
        f"{n_layers - 1} x {stats['requests_total']}), peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} B)")
    log(f"serve: first action chunk row {np.round(actions[0][0], 4).tolist()}")
    if stats["requests_total"] != N_REQUESTS or launches != expected:
        raise RuntimeError(f"launch count {launches} != {expected}")
    return server, image, proprio, launches


def model_kernel_vs_plain(server, image, proprio) -> None:
    """One control step on the served weights with and without the kernel;
    then the step's time both ways (host clock around a synchronized step,
    alternating kernel / plain)."""
    from blurr_tpu_torch.serving.server import noise_generator

    model = server.model
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    flash_spec = model.joint_spec
    plain_spec = dataclasses.replace(flash_spec, use_flash_attn=False)

    def step(spec):
        model.joint_spec = spec
        noise = torch.randn(
            server._noise_shape, device=server.device, dtype=server.dtype,
            generator=noise_generator(0, 0, server.device),
        )
        out = model.infer_action(*inputs, noise)
        torch.cuda.synchronize()
        return out

    try:
        a_flash, a_plain = step(flash_spec), step(plain_spec)
        diff = (a_flash.float() - a_plain.float()).abs().max().item()
        log(f"model: actions kernel vs plain attention max_abs_diff={diff:.3e} "
            f"(bound {MODEL_TOL:g})")
        if not (np.isfinite(diff) and diff <= MODEL_TOL):
            raise RuntimeError(f"kernel and plain control steps disagree: {diff}")
        times = {"kernel": [], "plain": []}
        for _ in range(5):
            for name, spec in (("kernel", flash_spec), ("plain", plain_spec),
                               ("plain", plain_spec), ("kernel", flash_spec)):
                t = time.monotonic()
                step(spec)
                times[name].append((time.monotonic() - t) * 1000.0)
        for name, ts in times.items():
            log(f"model: control step with {name} attention, ms median "
                f"{float(np.median(ts)):.3f} min {min(ts):.3f} over {len(ts)} "
                "(host clock, synchronized)")
    finally:
        model.joint_spec = flash_spec


def small_model_vs_cpu(device) -> None:
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.presets import apply_preset, load_config

    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32, prefix cache, 10 flow steps
    cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
    cfg["joint"]["config"]["use_flash_attn"] = True
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = PiZero(cfg, device=device, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    s = cpu.spec
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    size = cfg["vision"]["config"]["image_size"]
    rng = np.random.RandomState(0)
    ids = np.zeros((2, 80), np.int64)
    am = np.zeros((2, 80), np.int32)
    ids[:, :n_img] = s.image_token_index
    for b, n_valid in enumerate((n_img + 9, n_img + 30)):  # pad rows follow
        ids[b, n_img:n_valid] = rng.randint(3, 1000, n_valid - n_img)
        am[b, :n_valid] = 1
    inputs = [
        torch.from_numpy(ids), torch.from_numpy(am),
        torch.from_numpy(rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)),
        torch.from_numpy(rng.randn(2, 1, s.proprio_dim).astype(np.float32)),
        torch.from_numpy(rng.randn(2, 4, s.action_dim).astype(np.float32)),
    ]
    ref = cpu.infer_action(*inputs)
    before = flash_attention.launches
    out = gpu.infer_action(*(t.to(device) for t in inputs))
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    err = (out.cpu() - ref).abs().max().item()
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    log(f"small: fp32 bridge_tiny widths, prefix 81, card vs CPU actions "
        f"max_abs_err={err:.3e} (tol {SMALL_TOL:g}), kernel launches "
        f"{launches} (expected {n_layers - 1})")
    if not (torch.isfinite(out).all() and err <= SMALL_TOL):
        raise RuntimeError(f"card and CPU disagree on the small model: {err}")
    if launches != n_layers - 1:
        raise RuntimeError(f"small model launched the kernel {launches} times")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = probe()
    build()
    kernel = kernel_vs_plain(device)
    server, image, proprio, launches = served_control_steps(device)
    model_kernel_vs_plain(server, image, proprio)
    del server
    torch.cuda.empty_cache()
    small_model_vs_cpu(device)
    log(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "blurr_tpu_torch/csrc/flash_attention.cu",
        "replaces": "blurr_tpu/ops/pallas_attention.py:40",
        "launches": launches,
        **kernel,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
