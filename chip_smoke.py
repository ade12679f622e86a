#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: its main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
1. probe   - the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
             requires compute capability 9.0 (Hopper).
2. build   - builds every kernel of the paths from csrc/ with nvcc for
             sm_90a, one nvcc per source, all at once; prints ptxas's
             registers and spills.
3. kernel  - each kernel against its plain PyTorch version on the card at
             the shapes the paths give it. Flash attention: fp32 at 2e-4
             with TF32 off; bf16 against the plain version in fp32 at 2e-2;
             both timed with CUDA events at the Pi-0 prefill shape. The int4
             matmul: bit for bit (bound 1e-6 relative) at every w4a8 linear
             of the Pi-0 step; then it, its plain version and a bf16 matmul
             of the dense weight timed at the vlm and action gate shapes.
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
7. serve-w4a8 - bridge_pool64_w4a8_steps1.yaml at full width (vlm and action
             mixtures w4a8 through the int4 kernel, SigLIP w8a8), with
             joint.config.use_flash_attn set: random bf16 weights drawn on
             the card and quantized there, then 3 requests through
             ActionClient. Each answer must be a finite [4, 7] chunk in
             [-1, 1]; the int4 kernel must launch exactly 370 times and the
             flash kernel 17 times per control step; the resident weights
             must stay under 3.0 GB.
8. small-w4a8 - the small fp32 model quantized w4a8 (SigLIP w8a8) on the
             card against the same quantized weights on the CPU.
Then one JSON line of the kernels (launches summed over the two served
runs, the counts set to 0 just before each; errors and times measured
here), and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX and builds everything from the checkout.
"""

from __future__ import annotations

import copy
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
# the same, quantized: the int8 activations round alike on both sides, but
# an fp32 input within rounding of a half step may round the other way on
# one of them, which moves that activation by one step (1/127 of its row)
SMALL_W4A8_TOL = 1e-3
# the int4 kernel against its plain version: both sum exact int32 group dots
# times the scale in fp32, in group order, without FMA; any difference is a
# finding (PERF.md), bounded by 1e-6 of the largest output
INT4_REL_TOL = 1e-6
MAX_W4A8_WEIGHT_BYTES = 3.0e9
N_REQUESTS = 3
PI0_SHAPE = (1, 8, 1, 277, 277, 256)  # b, nh, kvh, sq, skv, d
KERNEL_SHAPES = [
    PI0_SHAPE,                  # the joint prefill, pad rows fully masked
    (1, 8, 1, 97, 97, 256),    # the pool64 prefill (96 + proprio)
    (2, 4, 2, 100, 150, 64),   # ragged GQA
    (1, 4, 1, 64, 64, 32),     # smallest head_dim
]
# (M, K, N, G) of every w4a8 linear of the pool64 step: vlm q/o, k/v, gate/up,
# down at the 96-token prefill; action (and proprio) q, k/v, o, gate/up, down
# at M 1 (proprio prefill) and 4 (decode)
INT4_SHAPES = [
    (96, 2048, 2048, 4), (96, 2048, 256, 4), (96, 2048, 16384, 4),
    (96, 16384, 2048, 32),
    (1, 1024, 2048, 2), (4, 1024, 2048, 2), (1, 1024, 256, 2), (4, 1024, 256, 2),
    (1, 2048, 1024, 4), (4, 2048, 1024, 4), (1, 1024, 4096, 2), (4, 1024, 4096, 2),
    (1, 4096, 1024, 8), (4, 4096, 1024, 8),
]
INT4_TIMED = [(96, 2048, 16384, 4), (4, 1024, 4096, 2)]  # vlm gate, action gate
KERNEL_NAMES = ("flash_attention", "int4_matmul")


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
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from blurr_tpu_torch.ops import kernels

    def one(name):
        t0 = time.monotonic()
        path = kernels.build(name)
        return path, time.monotonic() - t0

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        built = dict(zip(KERNEL_NAMES, pool.map(one, KERNEL_NAMES)))
    log(f"build: {len(KERNEL_NAMES)} kernels in {time.monotonic() - t0:.2f} s")
    for name, (path, secs) in built.items():
        kernels.load(name)
        log(f"build: {name} in {secs:.2f} s -> {path.relative_to(REPO_ROOT)}")
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name} ptxas {line.strip()}")


def _attention_inputs(shape, device):
    b, nh, kvh, sq, skv, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, nh, sq, d, generator=g, device=device) * 0.3
    k = torch.randn(b, kvh, skv, d, generator=g, device=device) * 0.3
    v = torch.randn(b, kvh, skv, d, generator=g, device=device)
    if nh == 8 and kvh == 1 and sq == skv:  # a Pi-0 prefill
        from blurr_tpu_torch.ops.masks import pi0_prefix_mask

        # the image tokens and a short prompt valid, 10 pad rows fully masked
        am = torch.zeros(b, sq - 1, dtype=torch.int32, device=device)
        am[:, :sq - 11] = 1
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


def int4_vs_plain(device) -> dict:
    """The int4 kernel against its plain version at every w4a8 shape of the
    step, then timed beside the plain version and a bf16 matmul of the
    dense weight (context for whether int4 pays on this card)."""
    from blurr_tpu_torch.ops.int4_matmul import (
        int4_matmul,
        int4_matmul_reference,
        pack_int4,
        pick_block_layout,
        to_block_major,
    )

    g = torch.Generator(device=device).manual_seed(1)

    def inputs(m, k, n, groups):
        bn, n_pad = pick_block_layout(n)
        q = torch.randint(-8, 8, (k, n_pad), dtype=torch.int8, device=device, generator=g)
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device, generator=g)
        # scales of the size the w4a8 quantizer gives Pi-0's weights
        s = torch.rand(groups, n_pad, device=device, generator=g) * 2e-3 + 1e-4
        return x, to_block_major(pack_int4(q), bn), s, q

    worst = 0.0
    for shape in INT4_SHAPES:
        x, packed, s, _ = inputs(*shape)
        out = int4_matmul(x, packed, s)
        ref = int4_matmul_reference(x, packed, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = INT4_REL_TOL * ref.abs().max().item()
        ms = _time_ms(lambda: int4_matmul(x, packed, s), iters=20)
        log(f"kernel: int4_matmul (M, K, N, G)={shape} max_abs_err={err:.3e} "
            f"bit-equal={torch.equal(out, ref)} (bound {bound:.3e}), kernel "
            f"{ms:.4f} ms (CUDA events, 20 launches)")
        if not (torch.isfinite(out).all() and err <= bound):
            raise RuntimeError(f"int4 kernel disagrees with its plain version at {shape}")
        worst = max(worst, err)
    times = {}
    for shape in INT4_TIMED:
        x, packed, s, q = inputs(*shape)
        xb, wb = x.bfloat16(), q.bfloat16()
        kern = _time_ms(lambda: int4_matmul(x, packed, s))
        plain = _time_ms(lambda: int4_matmul_reference(x, packed, s))
        dense = _time_ms(lambda: torch.matmul(xb, wb))
        kern2 = _time_ms(lambda: int4_matmul(x, packed, s))
        times[shape] = (min(kern, kern2), plain)
        log(f"kernel: int4_matmul time at (M, K, N, G)={shape}: kernel "
            f"{kern:.4f}/{kern2:.4f} ms, plain {plain:.4f} ms, bf16 matmul of "
            f"the dense weight {dense:.4f} ms (CUDA events, 50 launches each)")
    return {"max_abs_err": worst, "ms": times[INT4_TIMED[0]][0],
            "plain_ms": times[INT4_TIMED[0]][1]}


def _serve_requests(server, cfg, label):
    """N_REQUESTS through ActionClient with the kernel counts set to 0
    just before; returns the actions, the counts and the server stats."""
    from blurr_tpu.serving.client import ActionClient
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul

    ready = threading.Event()
    thread = threading.Thread(
        target=server.serve_forever, kwargs={"port": 0, "ready_event": ready},
        daemon=True,
    )
    thread.start()
    try:
        if not ready.wait(60):
            raise RuntimeError("server did not start listening")
        log(f"{label}: warmup {server.warmup():.2f} s")
        size = cfg["vision"]["config"]["image_size"]
        rng = np.random.RandomState(0)
        image = rng.randint(0, 256, (size, size, 3), np.uint8)
        proprio = rng.uniform(-1, 1, 7).tolist()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = int4_matmul.launches = 0
        latencies, actions = [], []
        with ActionClient(port=server.port) as client:
            for _ in range(N_REQUESTS):
                t = time.monotonic()
                actions.append(client.predict(image, "put the spoon on the towel", proprio))
                latencies.append((time.monotonic() - t) * 1000.0)
            stats = client.stats()
        launches = {"flash_attention": flash_attention.launches,
                    "int4_matmul": int4_matmul.launches}
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
        thread.join(30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    for a in actions:
        if a.shape != (4, 7) or not np.isfinite(a).all() or np.abs(a).max() > 1.0:
            raise RuntimeError(f"bad action chunk {a.shape}: {a}")
    if stats["requests_total"] != N_REQUESTS:
        raise RuntimeError(f"{stats['requests_total']} requests served")
    log(f"{label}: {stats['requests_total']} control steps, latency ms per "
        f"request (client) {[round(x, 3) for x in latencies]}, server p50 "
        f"{stats.get('latency_ms_p50')} ms, peak memory {peak / 2**30:.3f} GiB "
        f"({peak} B)")
    log(f"{label}: first action chunk row {np.round(actions[0][0], 4).tolist()}")
    return image, proprio, launches


def _check_launches(label, launches, per_step):
    for name, n in per_step.items():
        expected = n * N_REQUESTS
        log(f"{label}: {name} launches {launches[name]} (expected {expected} = "
            f"{n} per step x {N_REQUESTS})")
        if launches[name] != expected:
            raise RuntimeError(f"{name} launched {launches[name]} times, not {expected}")


def served_control_steps(device):
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
    image, proprio, launches = _serve_requests(server, cfg, "serve")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    # 18 layers, the last computes only K/V
    _check_launches("serve", launches, {"flash_attention": n_layers - 1, "int4_matmul": 0})
    return server, image, proprio, launches


def int4_launches_per_step(model) -> int:
    """The int4 kernel's launches in one control step: the prefill runs the
    vlm and proprio mixtures' 7 linears in every layer but the last, where
    it runs only q, k and v; each flow step's decode runs the action
    mixture's 7 linears in every layer."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    qkv = ("q_proj", "k_proj", "v_proj")
    rest = ("o_proj", "gate_proj", "up_proj", "down_proj")

    def count(layer, attrs):
        return sum(isinstance(getattr(layer, a), W4A8Linear) for a in attrs)

    prefill = sum(
        sum(count(layer, qkv + rest) for layer in model.joint[n].layers[:-1])
        + count(model.joint[n].layers[-1], qkv)
        for n in ("vlm", "proprio")
    )
    decode = sum(count(layer, qkv + rest) for layer in model.joint["action"].layers)
    return prefill + model.spec.num_inference_steps * decode


def resident_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()])


def served_w4a8_steps(device) -> dict:
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge_pool64_w4a8_steps1.yaml")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    weights = resident_bytes(model)
    log(f"serve-w4a8: bridge_pool64_w4a8_steps1.yaml, random {server.dtype} "
        f"weights drawn on the card and quantized there in "
        f"{time.monotonic() - t0:.2f} s; resident parameters and buffers "
        f"{weights} B ({weights / 1e9:.3f} GB, bound {MAX_W4A8_WEIGHT_BYTES / 1e9:g} GB), "
        f"allocated {torch.cuda.memory_allocated()} B")
    parts = {
        "embed_tokens": model.embed_tokens.numel() * model.embed_tokens.element_size(),
        "vlm mixture": resident_bytes(model.joint["vlm"]),
        "action mixture": resident_bytes(model.joint["action"]),
        "siglip": resident_bytes(model.vision_tower),
    }
    log(f"serve-w4a8: resident bytes by part {parts}")
    if weights > MAX_W4A8_WEIGHT_BYTES:
        raise RuntimeError(f"resident weights {weights} B over the bound")
    per_step = int4_launches_per_step(model)
    if per_step != 370:
        raise RuntimeError(f"the pool64 w4a8 step has {per_step} int4 linears, not 370")
    image, proprio, launches = _serve_requests(server, cfg, "serve-w4a8")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches("serve-w4a8", launches,
                    {"flash_attention": n_layers - 1, "int4_matmul": per_step})
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    times = []
    for i in range(10):
        t = time.monotonic()
        server._step(*inputs, request_idx=i)  # returns host numpy: synchronized
        times.append((time.monotonic() - t) * 1000.0)
    log(f"serve-w4a8: control step ms median {float(np.median(times)):.3f} "
        f"min {min(times):.3f} over {len(times)} (host clock, synchronized)")
    return launches


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


def small_model_vs_cpu(device, quant: str = "") -> None:
    """The small model on the card against the same weights on the CPU;
    with ``quant="w4a8"`` both hold the same w4a8 weights (quantized once,
    on the CPU), vlm and action mixtures through the int4 kernel and
    SigLIP w8a8."""
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul
    from blurr_tpu_torch.presets import apply_preset, load_config

    label, tol = ("small-w4a8", SMALL_W4A8_TOL) if quant else ("small", SMALL_TOL)
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32, prefix cache, 10 flow steps
    cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
    cfg["joint"]["config"]["use_flash_attn"] = True
    if quant:
        cfg["vlm_quantization"] = {"mode": quant, "include_vision": True}
        cfg["action_quantization"] = {"mode": quant, "activation_clip": None}
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    cpu.enable_action_quantization()
    cpu.enable_vlm_quantization()
    gpu = copy.deepcopy(cpu).to(device)
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
    flash_attention.launches = int4_matmul.launches = 0
    out = gpu.infer_action(*(t.to(device) for t in inputs))
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "int4_matmul": int4_matmul.launches}
    expected = {"flash_attention": cfg["joint"]["config"]["num_hidden_layers"] - 1,
                "int4_matmul": int4_launches_per_step(gpu)}
    err = (out.cpu() - ref).abs().max().item()
    log(f"{label}: fp32 bridge_tiny widths, prefix 81, card vs CPU actions "
        f"max_abs_err={err:.3e} (tol {tol:g}), kernel launches {launches} "
        f"(expected {expected})")
    if not (torch.isfinite(out).all() and err <= tol):
        raise RuntimeError(f"card and CPU disagree on the {label} model: {err}")
    if launches != expected:
        raise RuntimeError(f"the {label} model launched {launches}, not {expected}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = probe()
    build()
    flash = kernel_vs_plain(device)
    int4 = int4_vs_plain(device)
    server, image, proprio, launches = served_control_steps(device)
    model_kernel_vs_plain(server, image, proprio)
    del server
    torch.cuda.empty_cache()
    small_model_vs_cpu(device)
    w4a8_launches = served_w4a8_steps(device)
    torch.cuda.empty_cache()
    small_model_vs_cpu(device, "w4a8")
    total = {name: launches[name] + w4a8_launches[name] for name in KERNEL_NAMES}
    log(json.dumps({"kernels": [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "blurr_tpu_torch/csrc/flash_attention.cu",
            "replaces": "blurr_tpu/ops/pallas_attention.py:40",
            "launches": total["flash_attention"],
            **flash,
        },
        {
            "name": "int4_matmul",
            "route": "cuda",
            "source": "blurr_tpu_torch/csrc/int4_matmul.cu",
            "replaces": "blurr_tpu/ops/pallas_int4_matmul.py:109",
            "launches": total["int4_matmul"],
            **int4,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
