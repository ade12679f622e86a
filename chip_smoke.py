#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: its main paths on one CUDA card.

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
             each the same bits on a second call, its launch geometry
             logged, at the Pi-0 prefill over 1 and over 4 rows (the
             batched eval's), the naive step, the pool64 prefill, a ragged
             GQA shape and the smallest head_dim; timed at the Pi-0 prefill shape (fp32 and bf16, the
             kernels line's entry), at the naive step's 281 rows (fp32)
             and at the pool64 prefill (bf16), each beside its plain
             version, SDPA and its bound (fp32 against the peak outside
             the tensor cores). The int4 matmul: bit for
             bit (bound 1e-6 relative) at every w4a8 linear of the Pi-0
             step, the same bits on a second call, its split of K (S) and
             grid logged; then it, its plain version and a bf16 matmul of
             the dense weight timed at the vlm gate, the vlm down
             projection and the action gate.
             kernel-int8: the int8 matmul at the 13 (M, K, N) of the int8
             step, fp32 x within 1e-5 of the largest output and bf16 x
             within one bf16 rounding of each output, the same bits on a
             second call, its split of K (S) and grid logged; then it, its
             plain version, the library's int8 weight-only product
             (torch._weight_int8pack_mm, bf16 scales) and a bf16 matmul of
             the dequantized weight timed at the action gate and down
             projection shapes. Every kernel is
             timed two ways: CUDA events around 50 eager launches (which
             for a short kernel time its wrapper's host work) and inside a
             CUDA graph (the device's time alone).
3b. kernel-text - flash attention at Pi-0's text prefill: 276 query rows
             over a layer's slice of the stacked cache buffer of 296 keys,
             the last 20 masked (random there), at batch 1 and at batch 2
             with the second row right-padded; fp32 (2e-4) and bf16 (2e-2),
             the soft clamp 50 and off, each the same bits on a second call;
             at small logits (|logit| < 1) and with q and k x3 (the largest
             |logit| ~45), where clamp 50 and off must differ by more than
             10x the tolerance;
             timed at batch 1 in bf16 with both clamps beside the plain
             version, the bound and, for the clamp off, SDPA.
4. serve   - the port's ActionServer at the full bridge.yaml width with the
             blurr preset (bf16, prefix KV cache, one flow step) and
             joint.config.use_flash_attn set, random weights drawn on the
             card; 3 requests through the port's
             blurr_tpu_torch.serving.client.ActionClient. Each
             answer must be a finite [4, 7] chunk in [-1, 1], and the flash
             kernel must have launched exactly 17 times per control step
             (18 layers, the last computes only K/V); one step under
             torch.profiler gives the step's device time and the flash
             kernel's share.
5. model   - the same weights and inputs through one control step with the
             kernel and with the plain attention; the actions must agree.
5b. serve-checkpoint - the served weights written with
             checkpoint.save_torch_checkpoint (fp32, the reference's .pt
             layout) to a temporary directory, a second ActionServer
             started from that path (blurr preset), the file deleted; its
             parameters must equal the drawn ones and its 3 answers must be
             the same bits as the first server's. Logs the file's size and
             the write and load times.
6. small   - a small fp32 model (bridge_tiny widths, an 80-token prefix so
             the prefill takes the kernel) on the card against the same
             weights on the CPU, where the port runs its plain versions
             (the CPU tests hold those against the JAX package).
6b. serve-baseline - bridge.yaml with the baseline preset (fp32, no prefix
             cache, 10 flow steps) and joint.config.use_flash_attn set,
             random weights drawn on the card, 3 requests through
             ActionClient, checked as in serve; K1's fp32 kernel must launch
             exactly 180 times per control step (18 layers x 10 flow steps,
             281 rows each); the model-step median and one step under
             torch.profiler (device time, K1's share); the naive step
             against the cached one (the prefix_cache preset) on the same
             weights, inputs and noise within BASELINE_TOL, both timed.
6c. small-adaLN-Zero - the small fp32 model with an adaLN-Zero action
             expert, card against CPU, cached (2 launches of K1) and naive
             (30).
7. serve-w4a8 - bridge_pool64_w4a8_steps1.yaml at full width (vlm and action
             mixtures w4a8 through the int4 kernel, SigLIP w8a8), with
             joint.config.use_flash_attn set: random bf16 weights drawn on
             the card and quantized there, then 3 requests through
             ActionClient. Each answer must be a finite [4, 7] chunk in
             [-1, 1]; the int4 kernel must launch exactly 370 times and the
             flash kernel 17 times per control step; the resident weights
             must stay under 3.0 GB; one step under torch.profiler gives
             the step's device time and the int4 and flash kernels' shares.
8. small-w4a8 - the small fp32 model quantized w4a8 (SigLIP w8a8) on the
             card against the same quantized weights on the CPU.
9. serve-int8 - bridge_pool64_steps2.yaml at full width with
             action_quantization.cache_fp_weight set false (the int8 {q, s}
             tier: action expert and action encoder through the int8
             kernel, the int8 KV cache) and joint.config.use_flash_attn set:
             random bf16 weights drawn on the card and quantized there, then
             3 requests through ActionClient, checked as serve-w4a8; the
             int8 kernel must launch exactly 380 times per control step, the
             flash kernel 17 times, the int4 kernel never, and every decode
             must read an int8 prefix cache; one step under torch.profiler
             gives the step's device time and the int8 and flash kernels'
             shares.
10. serve-int8-cached - the preset as shipped (cache_fp_weight true: the
             action expert holds a bf16 copy of its int8 weights), the same
             checks and profile, with 0 launches of the int8 kernel.
11. small-int8 - the small fp32 model with the int8 {q, s} action expert
             and the int8 KV cache (clip 1.0, bf16), card against CPU; then
             again with the card given the CPU's rounding wherever a cached
             K/V value or an int8 kernel input rounds the other way, held
             to the fp32 bound.
12. kernel-experiments - the kernels of the experiment harnesses against
             their plain versions at every harness shape, bit for bit: the
             w8a8 product K4 (row-major at M 8 and 32, K 4096, N 11264;
             block-major at the 4 shapes of the int8 block-major harness),
             the split-half int4 product K5 signed and biased (M 8 and 32,
             each the same bits on a second call, its grid and split of K/2
             (S) and ptxas's registers and spills logged),
             K2 at one group on the adjacent-row (bitcast) packing (M 8, 32,
             96); the fused GeGLU FFN K6 at (280, 2048, 16384) within one
             bf16 step at its largest output and the same bits on a second
             call, the grid of its two phases (phase 1 gate, up and GeGLU
             on wgmma, a through L2; phase 2 the down product, K split into
             S slices in a cluster) and ptxas's registers and spills logged;
             K4 the same bits on a second call, its grid and split of K (S)
             logged. Each timed as the other kernels: K4 at all six harness
             shapes beside torch._int_mm and its bound (and, for
             information, _int_mm on a column-major copy of the weight), K5
             at both M signed and biased beside K4 at the same shape, K6
             beside three bf16 matmuls, and one K6 call's device time split
             between its two phases under torch.profiler.
13. experiments - the two experiment entry points run as a user runs them
             (bench_lowbit_matmul, bench_fused_ffn at 18 layers), with the
             counts set to 0 just before: K4, K5, K2 and K6 must each launch.
14. eval-agent - the port's EvalAgent at the full bridge.yaml width (blurr
             preset, joint.config.use_flash_attn set, random weights drawn
             on the card) on the fake env (480x640 frames resized on the
             host by the Lanczos ladder, whose rung is logged): 2 episodes
             of 12 env steps, act_steps 4. Both summary lines; K1 17 times
             per control step; every dispatched chunk bit-equal to
             infer_action called directly on the same inputs and noise; the
             steady p50 and the peak memory beside the card's name and power
             limit; then the agent's control step timed 20 times on one
             frame (median, min, max), and each rung of the resize ladder.
15. from-frame - infer_action_from_frame on the fake env's 480x640 frame on
             the card: the in-graph lanczos3 resize (fp32, TF32 off) against
             the CPU's within FRAME_TOL, the step bit-equal to infer_action
             on the card's pixel values, K1 17 times.
16. eval-agent-async - phase 14's agent again with the async pipeline turned
             on (its dispatch index set back to 0): the same checks and the
             residual-fetch line; then one dispatch under
             torch.cuda.set_sync_debug_mode("warn"), which must find no
             synchronizing operation, its host time beside the fetch's wait.
17. eval-batched - BatchedEvalAgent, 4 envs in lockstep over 4 episodes; each
             row of every batched chunk against the batch-1 step on that
             row's inputs and noise within BATCHED_TOL; K1 17 times per step;
             then a round of 4 and a batch-1 step timed 20 times each.
18. eval-agent-w4a8 - bridge_pool64_w4a8_steps1.yaml through the agent as
             shipped (act_steps 1): K2 370 and K1 17 times per step, every
             chunk bit-equal to a direct infer_action, and the agent's
             quantization-failure warning must not fire; the control step
             timed 20 times.
19. eval-cli - scripts/eval_pi0_simpler_torch.py run as a user runs it
             (bridge_pool64_w4a8_steps1.yaml, blurr preset, 2 episodes) in a
             subprocess: exit 0, both summary lines in its run.log and no
             quantization-failure warning there. (Its launches happen in
             another process and cannot count; phase 18 is the one whose
             K2 launches count.)
20. small-agent - bridge_tiny widths (an 80-token prefix, so the prefill
             takes K1), fp32, 10 flow steps: the same weights in an agent on
             the CPU and one on the card, the same summary lines and every
             chunk within SMALL_TOL.
21. text-pi0 - Pi-0's text mode (infer_text_prefill, infer_text_decode_step)
             at the full bridge.yaml width, bf16, joint.config.use_flash_attn
             set, random weights drawn on the card: a 276-token prompt and 20
             tokens at batch 1 (timed 3 times: prefill and per-token decode
             medians, tokens/s, peak memory) and at batch 2 with a row
             right-padded by 10. Each prefill launches K1 exactly 18 times,
             each decode step never. The K1 route against the plain
             attention on the same weights: the prefill's last logits and the
             decode logits teacher-forced on the same tokens within
             TEXT_REL_TOL of the largest |logit| (greedy agreement printed,
             not gated: random weights tie). The padded row against that row
             alone, the decode teacher-forced on the batch's tokens: printed
             in bf16; in fp32 on the same weights (K1's fp32 kernel at 276
             and 266 rows) its logits within TEXT_FP32_TOL of the largest
             |logit| and its tokens equal.
22. text-paligemma - PaliGemma-3B at google/paligemma-3b-pt-224's widths,
             bf16 random weights drawn on the card, written as 2 safetensors
             shards under HF keys with a config.json (bytes and seconds
             logged) and loaded by load_hf_model into a fresh model: the same
             bits, the same tokens and, teacher-forced on them, the same
             prefill and decode logits bit for bit (random weights repeat one
             token, so the tokens alone say little); generate and
             generate_fused equal, generate_fused's device part
             (fused_tokens) finds no synchronizing operation under
             set_sync_debug_mode("warn") and its last step's logits are
             generate's teacher-forced ones, bit for bit; the
             prefill, per-token decode and generate_fused timed (medians,
             tokens/s, peak memory); GemmaForCausalLM on the same weights
             equal to PaliGemma's stack on the same embeddings, tokens and
             teacher-forced logits bit for bit. Plain
             attention without the clamp, as in JAX: no kernel launches.
23. small-text - a small Pi-0 text model (bridge_tiny widths, fp32, an
             80-token prompt so the prefill takes K1, a padded row) and a
             small PaliGemma, each on the card against the CPU: tokens equal,
             logits within SMALL_TOL.
Then one JSON line of the kernels (launches summed over the six served
runs, the experiments run, the eval runs of phases 14-18 and 20 and the
text runs of phases 21-23, the counts set to 0 just before each; errors
and times measured here: ms and plain_ms with CUDA events, graph_ms and
plain_graph_ms in a CUDA graph, library_ms of one PyTorch call of the same
function where there is one, at the first timed shape of each kernel;
bound_ms, the larger of the bytes each input read once and the output
written once over 3.35 TB/s and the operations over the card's peak for
their type, computed from those inputs), and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX nor of the JAX package, and builds everything
from the checkout.
"""

from __future__ import annotations

import copy
import itertools
import dataclasses
import json
import logging
import os
import sys
import tempfile
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

from blurr_tpu_torch.experiments.timing import bound as _bound  # noqa: E402
from blurr_tpu_torch.experiments.timing import card  # noqa: E402
from blurr_tpu_torch.experiments.timing import events_ms as _time_ms  # noqa: E402
from blurr_tpu_torch.experiments.timing import graph_ms as _graph_ms  # noqa: E402

FP32_TOL = 2e-4  # fp32 sums in another order (TF32 off)
BF16_TOL = 2e-2  # bf16 output rounding against the fp32 plain version
# kernel vs plain attention through the whole bf16 control step: both round
# P to bf16 for P@V, but the kernel rounds the unnormalized p (and divides by
# l after, in fp32) where the plain path rounds the normalized weights, and
# the sums run in another order, in each of 17 layers of a random-weight
# model; 5e-2 is ~13 bf16 ulps at 1.0
MODEL_TOL = 5e-2
# fp32 on the card (kernel, cuBLAS with TF32 off) against fp32 on the CPU:
# the same formulas summed in another order through 10 flow steps
SMALL_TOL = 1e-4
# the same, quantized: the int8 activations round alike on both sides, but
# an fp32 input within rounding of a half step may round the other way on
# one of them, which moves that activation by one step (1/127 of its row)
SMALL_W4A8_TOL = 1e-3
# the same with the int8 weight-only tier and the int8 KV cache. The card's
# fp32 prefix K/V and activations differ from the CPU's by fp32 noise, so a
# few values round the other way: a cached K/V value to the other int8 step
# (clip/127), a kernel input to the other bf16. Each such flip cascades
# through the flow steps (H100: 2 of 31,104 cached values flipped and the
# actions moved by 4.0e-4; with the KV cache fp, bf16 flips alone moved them
# by 3.4e-4). The phase's second witness gives the card the CPU's rounding
# wherever the two differ and holds that run to SMALL_TOL; a kernel that
# skips the bf16 rounding of its input stays 1.4e-3 away there
SMALL_INT8_TOL = 1e-3
# the fp32 naive step against the fp32 cached step on the card (TF32 off):
# the same function, the prefix K/V computed in every flow step and the
# action rows attended through the kernel over 281 keys instead of the
# plain decode attention, summed in another order through 10 flow steps
BASELINE_TOL = 1e-3
# the int4 kernel against its plain version: both sum exact int32 group dots
# times the scale in fp32, in group order, without FMA; any difference is a
# finding (PERF.md), bounded by 1e-6 of the largest output
INT4_REL_TOL = 1e-6
MAX_W4A8_WEIGHT_BYTES = 3.0e9
N_REQUESTS = 3
AGENT_TIMED_STEPS = 20  # control steps timed after each eval-agent run
PI0_SHAPE = (1, 8, 1, 277, 277, 256)  # b, nh, kvh, sq, skv, d
NAIVE_SHAPE = (1, 8, 1, 281, 281, 256)  # the naive step: 276 + proprio + 4 actions
POOL64_SHAPE = (1, 8, 1, 97, 97, 256)
BATCHED_SHAPE = (4, 8, 1, 277, 277, 256)  # the batched eval's prefill, 4 envs
KERNEL_SHAPES = [
    PI0_SHAPE,                  # the joint prefill, pad rows fully masked
    BATCHED_SHAPE,              # the same over 4 rows, each its own prompt length
    NAIVE_SHAPE,                # the naive step's joint attention, full block mask
    POOL64_SHAPE,               # the pool64 prefill (96 + proprio)
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
# vlm gate (first: the kernels line's entry), vlm down projection, action gate
INT4_TIMED = [(96, 2048, 16384, 4), (96, 16384, 2048, 32), (4, 1024, 4096, 2)]
# (M, K, N) of every int8 linear of the pool64 int8 step: action (and
# proprio) q, k/v, o, gate/up, down at M 1 (proprio prefill) and 4 (decode);
# the action encoder's w1, w2, w3 at M 4
INT8_SHAPES = [
    (1, 1024, 2048), (4, 1024, 2048), (1, 1024, 256), (4, 1024, 256),
    (1, 2048, 1024), (4, 2048, 1024), (1, 1024, 4096), (4, 1024, 4096),
    (1, 4096, 1024), (4, 4096, 1024),
    (4, 7, 1024), (4, 2048, 1024), (4, 1024, 1024),
]
INT8_TIMED = [(4, 1024, 4096), (4, 4096, 1024)]  # action gate, action down
# the int8 kernel's fp32 sum against the plain version's float64 one
INT8_FP32_REL_TOL = 1e-5
BF16_ROUNDING = 2.0**-8  # one bf16 rounding, relative (8 significant bits)
INT8_STEP_LAUNCHES = 380  # 17 x 7 + 3 proprio prefill, 2 x (18 x 7 + 3) decode
W4A8_STEP_LAUNCHES = 370  # 2 x (17 x 7 + 3) prefill (vlm, proprio), 18 x 7 decode
KERNEL_NAMES = ("flash_attention", "int4_matmul", "int8_matmul", "w8a8_matmul",
                "int4_split_matmul", "fused_ffn")
# Pi-0's text prefill (bridge.yaml): 276 prompt rows over a cache of 296
# keys (20 new tokens), the last 20 keys masked; and 2 rows, the second
# right-padded by TEXT_PAD
TEXT_NEW_TOKENS = 20
TEXT_PAD = 10
TEXT_SHAPE = (1, 8, 1, 276, 276 + TEXT_NEW_TOKENS, 256)
TEXT_PADDED_SHAPE = (2, 8, 1, 276, 276 + TEXT_NEW_TOKENS, 256)
# q and k at this scale (per element, d = 256) give logits of std ~9, the
# largest past 20 (the clamp takes 45 to 36): where clamp 50 and off differ
TEXT_LARGE_QK = 3.0
# the bf16 text path through K1 against the plain attention on the same
# weights (the prefill's last logits, the decode logits teacher-forced on
# the same tokens), as a share of the largest |logit|: both round at the
# same places, the kernel's P and its sums in another order, through 18
# layers. On an H100 the sound path reads 0.76%; K1 given the cache's 20
# masked keys unmasked (a planted fault) reads 6.9% on the prefill and 4.8%
# teacher-forced. 2e-2 sits between them.
TEXT_REL_TOL = 2e-2
# fp32 (TF32 off), the padded row of a batch against that row alone, as a
# share of the largest |logit|: the same sums, but matmuls of another M may
# take another order. On an H100 it reads 6.3e-7; decode steps that let
# the pad slots through (a planted fault) read 1.9e-2.
TEXT_FP32_TOL = 1e-4
# google/paligemma-3b-pt-224's config.json: its widths, as
# blurr_tpu/config/eval/paligemma_arch.yaml gives them
PALIGEMMA_3B = {
    "model_type": "paligemma", "image_token_index": 257152, "pad_token_id": 0,
    "projection_dim": 2048, "hidden_size": 2048, "vocab_size": 257216,
    "text_config": {"model_type": "gemma", "vocab_size": 257216, "hidden_size": 2048,
                    "intermediate_size": 16384, "num_hidden_layers": 18,
                    "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
                    "num_image_tokens": 256},
    "vision_config": {"model_type": "siglip_vision_model", "hidden_size": 1152,
                      "intermediate_size": 4304, "num_hidden_layers": 27,
                      "num_attention_heads": 16, "image_size": 224, "patch_size": 14,
                      "projection_dim": 2048},
}
# the small text models card against CPU (fp32, TF32 off)
SMALL_PALIGEMMA = {
    "vision_config": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 4, "image_size": 56, "patch_size": 14},
    "text_config": {"vocab_size": 1000, "hidden_size": 128, "intermediate_size": 512,
                    "num_hidden_layers": 2, "num_attention_heads": 8,
                    "num_key_value_heads": 1, "head_dim": 32},
    "image_token_index": 999, "pad_token_id": 0, "projection_dim": 128, "hidden_size": 128,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def probe() -> str:
    smi = card()
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
    if nh == 8 and kvh == 1 and sq == skv:  # a Pi-0 prefill or naive step
        from blurr_tpu_torch.ops.masks import pi0_full_mask, pi0_prefix_mask

        # the image tokens and a short prompt valid, 10 pad rows fully masked
        # (3 more in each further batch row, so every row has its own mask)
        n_text = 276 if sq == NAIVE_SHAPE[3] else sq - 1
        am = torch.zeros(b, n_text, dtype=torch.int32, device=device)
        for i in range(b):
            am[i, :n_text - 10 - 3 * i] = 1
        mask = (pi0_full_mask(am, n_text, 1, 4) if sq == NAIVE_SHAPE[3]
                else pi0_prefix_mask(am, n_text, 1))
    else:
        mask = torch.rand(b, sq, skv, generator=g, device=device) > 0.3
        mask[:, :, 0] = True
    return q, k, v, mask


def _kernel_times(kernel, plain, library=None) -> dict:
    """The times of the kernels line, taken the same way for every kernel:
    ``ms`` and ``plain_ms`` with CUDA events around 50 eager launches (the
    kernel's the lesser of two runs), ``graph_ms`` and ``plain_graph_ms``
    inside a CUDA graph (the device's time alone); ``library_ms`` (events)
    and ``library_graph_ms`` of one PyTorch call of the same function, or
    None where there is none."""
    return {"ms": min(_time_ms(kernel), _time_ms(kernel)), "plain_ms": _time_ms(plain),
            "graph_ms": min(_graph_ms(kernel), _graph_ms(kernel)),
            "plain_graph_ms": _graph_ms(plain),
            "library_ms": None if library is None else _time_ms(library),
            "library_graph_ms": None if library is None else _graph_ms(library)}


def _fmt_times(t: dict, dense=None, dense_name: str = "") -> str:
    """The times of ``_kernel_times``; with ``dense``, a bf16 matmul of the
    dequantized weight timed both ways (context, not in the kernels line)."""
    line = (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (CUDA events, 50 "
            f"launches each); in a CUDA graph kernel {t['graph_ms']:.4f} ms, plain "
            f"{t['plain_graph_ms']:.4f} ms")
    if t["library_ms"] is not None:
        line += (f"; library call {t['library_ms']:.4f} ms (events), "
                 f"{t['library_graph_ms']:.4f} ms (graph)")
    if dense is not None:
        line += (f"; bf16 matmul of {dense_name} {_time_ms(dense):.4f} ms (events), "
                 f"{_graph_ms(dense):.4f} ms (graph)")
    return line


def kernel_vs_plain(device) -> dict:
    """Flash attention against its plain version at every kernel shape, fp32
    and bf16, each the same bits on a second call (its launch geometry
    logged); then timed at the two prefill shapes beside the plain version,
    SDPA (the library's fused attention, without the soft clamp) and the
    bound: bf16 and fp32 at the 277-row prefill, fp32 at the naive step's
    281 rows, bf16 at the pool64 prefill. Returns the kernels line's entry:
    bf16 at the Pi-0 prefill."""
    from blurr_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        grid,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for shape in KERNEL_SHAPES:
        q, k, v, mask = _attention_inputs(shape, device)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            out = flash_attention(qc, kc, vc, mask)
            again = torch.equal(out, flash_attention(qc, kc, vc, mask))
            ref = flash_attention_reference(qc.float(), kc.float(), vc.float(), mask)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
            err = (out.float() - ref).abs().max().item()
            blocks, part_keys = grid(*shape, dtype)
            log(f"kernel: flash_attention {shape} {str(dtype)[6:]} "
                f"max_abs_err={err:.3e} (tol {tol:g}), same bits on a second call {again}; "
                f"grid {blocks}" + (f" (64-row tiles of the folded heads, {blocks[1]} key "
                                    f"parts of {part_keys} keys, batch x KV heads)"
                                    if part_keys else " (16-query tiles, heads, batch)"))
            torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
            if not again:
                raise RuntimeError(f"kernel gives other bits on a second call at {shape} {dtype}")
            errs[(shape, dtype)] = err
    times, bounds = {}, {}
    for shape, dtypes in ((PI0_SHAPE, (torch.bfloat16, torch.float32)),
                          (NAIVE_SHAPE, (torch.float32,)),
                          (POOL64_SHAPE, (torch.bfloat16,))):
        q, k, v, mask = _attention_inputs(shape, device)
        b, nh, _, sq, skv, d = shape
        for dtype in dtypes:
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            times[(shape, dtype)] = _kernel_times(
                lambda: flash_attention(qc, kc, vc, mask),
                lambda: flash_attention_reference(qc, kc, vc, mask),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
            log(f"kernel: time at {shape} {str(dtype)[6:]}: "
                f"{_fmt_times(times[(shape, dtype)])}")
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"
            bounds[(shape, dtype)] = bound = _bound(
                (qc, kc, vc, mask), (qc,), 4 * b * nh * sq * skv * d, kind)
            log(f"kernel: flash_attention bound at {shape} {kind} {bound['bound_ms']:.5f} ms "
                f"({bound['bound_by']}{', peak outside the tensor cores' if kind == 'fp32' else ''})")
    key = (PI0_SHAPE, torch.bfloat16)
    return {"max_abs_err": errs[key], **times[key], **bounds[key]}


def kernel_text_vs_plain(device) -> None:
    """K1 at Pi-0's text prefill: 276 query rows over a layer's slice of the
    stacked [L, B, KVH, 296, D] cache buffer, the 20 unwritten keys masked
    (random there, so a leak shows), at batch 1 and at batch 2 with the
    second row right-padded; fp32 and bf16, the soft clamp 50 and off, each
    against the plain version and the same bits on a second call (its grid
    logged). Each at two scales of q and k: small logits (|logit| < 1, as
    random weights give) and TEXT_LARGE_QK, whose largest |logit| is past
    20, where the clamp moves a logit by more than 1: there the kernel's
    two clamps must differ by more than the tolerance, so a kernel that
    ignored its clamp fails. Then timed at batch 1, bf16, both clamps,
    beside the plain version, its bound and, for the clamp off, SDPA (the
    same function)."""
    from blurr_tpu_torch.models.pi0.pizero import text_mask
    from blurr_tpu_torch.ops.attention import DEFAULT_SOFTCLAMP
    from blurr_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        grid,
    )

    smi = card()
    inputs = {}
    for shape, qk_scale in itertools.product((TEXT_SHAPE, TEXT_PADDED_SHAPE),
                                             (0.3, TEXT_LARGE_QK)):
        b, nh, kvh, sq, skv, d = shape
        g = torch.Generator(device=device).manual_seed(4)
        q = torch.randn(b, nh, sq, d, generator=g, device=device) * qk_scale
        k_buf = torch.randn(2, b, kvh, skv, d, generator=g, device=device) * qk_scale
        v_buf = torch.randn(2, b, kvh, skv, d, generator=g, device=device)
        valid = torch.ones(b, sq, dtype=torch.bool, device=device)
        valid[1:, sq - TEXT_PAD:] = False
        mask = text_mask(valid, sq, skv)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            qc, kc, vc = q.to(dtype), k_buf.to(dtype)[1], v_buf.to(dtype)[1]
            if qk_scale != TEXT_LARGE_QK:
                inputs[(shape, dtype)] = qc, kc, vc, mask
            logits = torch.einsum("bhqd,bsd->bhqs", qc.float(), kc[:, 0].float()) * d ** -0.5
            top = logits.masked_fill(~mask[:, None], 0).abs().max().item()
            blocks, part_keys = grid(*shape, dtype)
            outs = {}
            for clamp in (DEFAULT_SOFTCLAMP, None):
                out = flash_attention(qc, kc, vc, mask, softclamp=clamp)
                again = torch.equal(out, flash_attention(qc, kc, vc, mask, softclamp=clamp))
                ref = flash_attention_reference(qc.float(), kc.float(), vc.float(), mask, clamp)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                log(f"kernel-text: flash_attention {shape} {str(dtype)[6:]} softclamp {clamp}, "
                    f"q and k x{qk_scale:g} (largest |logit| {top:.2f}), K/V a layer's slice "
                    f"of the cache buffer, keys {sq}.. masked"
                    f"{f', row 1 padded by {TEXT_PAD}' if b > 1 else ''}: max_abs_err={err:.3e} "
                    f"(tol {tol:g}), same bits on a second call {again}; grid {blocks}"
                    + (f" ({blocks[1]} key parts of {part_keys} keys)" if part_keys else ""))
                if not torch.isfinite(out).all():
                    raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
                torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
                if not again:
                    raise RuntimeError(f"kernel gives other bits on a second call at {shape}")
                outs[clamp] = out.float()
            apart = (outs[DEFAULT_SOFTCLAMP] - outs[None]).abs().max().item()
            log(f"kernel-text: clamp 50 against off at {shape} {str(dtype)[6:]} x{qk_scale:g}: "
                f"max_abs_diff={apart:.3e}")
            if qk_scale == TEXT_LARGE_QK and not (top > 20 and apart > 10 * tol):
                raise RuntimeError(f"kernel-text: the clamp does not show at {shape} {dtype}: "
                                   f"largest |logit| {top}, clamp 50 vs off {apart}")
    qc, kc, vc, mask = inputs[(TEXT_SHAPE, torch.bfloat16)]
    b, nh, _, sq, skv, d = TEXT_SHAPE
    # the work these inputs need: the 276 unmasked keys of every row
    least = _bound((qc, kc, vc, mask), (qc,), 4 * b * nh * sq * sq * d, "bf16")
    for clamp in (DEFAULT_SOFTCLAMP, None):
        sdpa = None if clamp else (lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
        times = _kernel_times(lambda: flash_attention(qc, kc, vc, mask, softclamp=clamp),
                              lambda: flash_attention_reference(qc, kc, vc, mask, clamp), sdpa)
        log(f"kernel-text: time at {TEXT_SHAPE} bf16 softclamp {clamp}: {_fmt_times(times)}; "
            f"bound {least['bound_ms']:.5f} ms ({least['bound_by']}, 276 keys a row); "
            f"on {smi}")


def int4_vs_plain(device) -> dict:
    """The int4 kernel against its plain version at every w4a8 shape of the
    step, the same bits on a second call (its split of K and grid logged),
    then timed beside the plain version and a bf16 matmul of the dense
    weight (the yardstick: whether int4 pays on this card)."""
    from blurr_tpu_torch.ops.int4_matmul import (
        grid,
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
    bounds = {}
    for shape in INT4_SHAPES:
        x, packed, s, _ = inputs(*shape)
        out = int4_matmul(x, packed, s)
        again = torch.equal(out, int4_matmul(x, packed, s))
        ref = int4_matmul_reference(x, packed, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = INT4_REL_TOL * ref.abs().max().item()
        ms = _time_ms(lambda: int4_matmul(x, packed, s), iters=20)
        graph_ms = _graph_ms(lambda: int4_matmul(x, packed, s))
        m, k, _, groups = shape
        blocks = grid(m, k, s.shape[1], groups)
        log(f"kernel: int4_matmul (M, K, N, G)={shape} max_abs_err={err:.3e} "
            f"bit-equal={torch.equal(out, ref)} (bound {bound:.3e}), same bits on a "
            f"second call {again}; S={blocks[1]} slices of K, grid {blocks}; kernel "
            f"{ms:.4f} ms (CUDA events, 20 launches), {graph_ms:.4f} ms in a CUDA graph")
        if not (torch.isfinite(out).all() and err <= bound and again):
            raise RuntimeError(f"int4 kernel disagrees with its plain version at {shape}")
        worst = max(worst, err)
    times = {}
    for shape in INT4_TIMED:
        x, packed, s, q = inputs(*shape)
        xb, wb = x.bfloat16(), q.bfloat16()
        times[shape] = _kernel_times(lambda: int4_matmul(x, packed, s),
                                     lambda: int4_matmul_reference(x, packed, s))
        m, k, n, _ = shape
        bounds[shape] = _bound((x, packed, s), (torch.empty(m, s.shape[1], device=device),),
                               2 * m * k * n, "int8")
        line = _fmt_times(times[shape], lambda: torch.matmul(xb, wb), "the dense weight")
        log(f"kernel: int4_matmul time at (M, K, N, G)={shape}: {line}; bound "
            f"{bounds[shape]['bound_ms']:.5f} ms ({bounds[shape]['bound_by']})")
    return {"max_abs_err": worst, **times[INT4_TIMED[0]], **bounds[INT4_TIMED[0]]}


def int8_vs_plain(device) -> dict:
    """The int8 kernel against its plain version at every int8 shape of the
    step, fp32 and bf16 x, each giving the same bits on a second call (its
    split of K and grid logged), then timed (bf16 x, the served dtype)
    beside the plain version, a bf16 matmul of the dequantized weight and
    the library's int8 weight-only product (``torch._weight_int8pack_mm``:
    bf16 scales, so close to the kernel's function but not equal), each
    both ways: launches timed with CUDA events, which at these shapes time
    the wrapper's host work, and inside a CUDA graph, which times the
    device. Returns the largest fp32 error (the kernel's own summation) and
    the times at the action gate."""
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference, slices

    g = torch.Generator(device=device).manual_seed(2)

    def inputs(m, k, n):
        x = torch.randn(m, k, device=device, generator=g) * 2
        q = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=device, generator=g)
        # scales of the size the int8 quantizer gives Pi-0's weights
        s = torch.rand(n, device=device, generator=g) * 2e-4 + 1e-5
        return x, q, s

    worst_fp32 = 0.0
    bounds = {}
    for shape in INT8_SHAPES:
        x, q, s = inputs(*shape)
        ref = int8_matmul_reference(x, q, s)  # fp32; rounds x to bf16 itself
        top = ref.abs().max().item()
        m, k, n = shape
        split = slices(m, k, n)
        for dtype in (torch.float32, torch.bfloat16):
            out = int8_matmul(x.to(dtype), q, s)
            again = torch.equal(out, int8_matmul(x.to(dtype), q, s))
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            bound = INT8_FP32_REL_TOL * top
            if dtype == torch.bfloat16:
                bound = bound + BF16_ROUNDING * ref.abs()
            ok = bool(torch.isfinite(out).all()) and bool((err <= bound).all()) and again
            log(f"kernel: int8_matmul (M, K, N)={shape} {str(dtype)[6:]} "
                f"max_abs_err={err.max().item():.3e} (bound {INT8_FP32_REL_TOL * top:.3e}"
                f"{' + one bf16 rounding of each output' if dtype == torch.bfloat16 else ''}), "
                f"same bits on a second call {again}; S={split} slices of K, grid "
                f"{(-(-n // 64), split, -(-m // 16))}")
            if not ok:
                raise RuntimeError(f"int8 kernel disagrees with its plain version at {shape} {dtype}")
            if dtype == torch.float32:
                worst_fp32 = max(worst_fp32, err.max().item())
        xb = x.bfloat16()
        ms = _time_ms(lambda: int8_matmul(xb, q, s), iters=20)
        graph_ms = _graph_ms(lambda: int8_matmul(xb, q, s))
        log(f"kernel: int8_matmul (M, K, N)={shape} bf16 kernel {ms:.4f} ms "
            f"(CUDA events, 20 launches), {graph_ms:.4f} ms in a CUDA graph")
    times = {}
    for shape in INT8_TIMED:
        x, q, s = inputs(*shape)
        xb = x.bfloat16()
        wb = (q.float() * s).bfloat16()
        q_nk, s_bf16 = q.t().contiguous(), s.bfloat16()  # the library's layout: [N, K]
        times[shape] = _kernel_times(lambda: int8_matmul(xb, q, s),
                                     lambda: int8_matmul_reference(xb, q, s),
                                     lambda: torch._weight_int8pack_mm(xb, q_nk, s_bf16))
        m, k, n = shape
        bounds[shape] = _bound((xb, q, s), (xb.new_empty(m, n),), 2 * m * k * n, "bf16")
        line = _fmt_times(times[shape], lambda: torch.matmul(xb, wb), "the dequantized weight")
        log(f"kernel: int8_matmul time at (M, K, N)={shape} bf16: {line}; bound "
            f"{bounds[shape]['bound_ms']:.5f} ms ({bounds[shape]['bound_by']})")
    return {"max_abs_err": worst_fp32, **times[INT8_TIMED[0]], **bounds[INT8_TIMED[0]]}


def experiments_vs_plain(device) -> dict:
    """The kernels of the experiment harnesses against their plain versions
    at every harness shape, with scales that are not 1 so the rounding of
    the int32 dot and the multiply show: K4, K5 and K2 at one group bit for
    bit, K6 within one bf16 step at its largest output. Then each timed at
    its first shape (K4 at every harness shape beside torch._int_mm, K6
    beside the three bf16 matmuls). Returns each kernel's entry of the
    kernels line."""
    from blurr_tpu_torch.experiments import bench_fused_ffn, bench_lowbit_matmul, lowbit
    from blurr_tpu_torch.experiments.bench_lowbit_matmul import (
        ADJACENT_M,
        BLOCK_MAJOR,
        ROW_MAJOR_M,
        block_major_width,
    )
    from blurr_tpu_torch.ops import kernels
    from blurr_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_reference
    from blurr_tpu_torch.ops.fused_ffn import _CLUSTERS as FFN_CLUSTERS
    from blurr_tpu_torch.ops.fused_ffn import card_clusters as ffn_clusters
    from blurr_tpu_torch.ops.fused_ffn import kernel_grid as ffn_grid
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul_reference, pack_int4, to_block_major
    from blurr_tpu_torch.ops.int4_split_matmul import grid as split_grid
    from blurr_tpu_torch.ops.int4_split_matmul import (
        int4_split_matmul,
        int4_split_matmul_reference,
    )
    from blurr_tpu_torch.ops.quant import INT_MM_PAD_ROWS
    from blurr_tpu_torch.ops.w8a8_matmul import grid as w8a8_grid
    from blurr_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_reference

    g = torch.Generator(device=device).manual_seed(3)
    k, n = bench_lowbit_matmul.K, bench_lowbit_matmul.NP

    def randint(shape, low=-127, high=128):
        return torch.randint(low, high, shape, dtype=torch.int8, device=device, generator=g)

    def scales(cols):
        return torch.rand(1, cols, device=device, generator=g) * 1e-2 + 1e-4

    def held(name, shape, out, ref) -> float:
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"kernel-experiments: {name} (M, K, N)={shape} max_abs_err={err:.3e} "
            f"bit-equal={torch.equal(out, ref)}")
        if not torch.equal(out, ref):
            raise RuntimeError(f"{name} disagrees with its plain version at {shape}")
        return err

    entries = {}
    # K4: the w8a8 product, row-major and block-major, each the same bits on
    # a second call, then timed at every harness shape (the kernels line's
    # entry: the first)
    w8a8_shapes = ([(m, k, n, None) for m in ROW_MAJOR_M]
                   + [(m, kk, nn, block_major_width(nn)) for m, kk, nn in BLOCK_MAJOR])
    worst = 0.0
    k4_graph_ms = {}  # K4's graph time at each row-major shape: K5's yardstick
    for m, kk, nn, bn in w8a8_shapes:
        x, w, s = randint((m, kk)), randint((kk, nn)), scales(nn)
        wl = w if bn is None else lowbit.int8_block_major(w, bn)
        out = w8a8_matmul(x, wl, s)
        again = torch.equal(out, w8a8_matmul(x, wl, s))
        blocks = w8a8_grid(m, kk, nn, bn or nn)
        layout = "row-major" if bn is None else f"block-major BN {bn}"
        worst = max(worst, held(f"w8a8_matmul {layout}", (m, kk, nn), out,
                                w8a8_matmul_reference(x, wl, s)))
        log(f"kernel-experiments: w8a8_matmul (M, K, N)={(m, kk, nn)} same bits on a second "
            f"call {again}; S={blocks[1]} slices of K, grid {blocks} (column tiles, S, row "
            f"blocks)")
        if not again:
            raise RuntimeError(f"w8a8_matmul gives other bits on a second call at {(m, kk, nn)}")
        # torch._int_mm takes M > 16 on CUDA: the rows padded once, outside;
        # its column-major copy of the weight, made once, is for information
        xp = torch.nn.functional.pad(x, (0, 0, 0, max(0, INT_MM_PAD_ROWS - m)))
        w_cm = w.t().contiguous().t()
        times = _kernel_times(lambda: w8a8_matmul(x, wl, s),
                              lambda: w8a8_matmul_reference(x, wl, s),
                              lambda: torch._int_mm(xp, w))
        least = _bound((x, wl, s), (out,), 2 * m * kk * nn, "int8")
        col_major = _graph_ms(lambda: torch._int_mm(xp, w_cm))
        log(f"kernel-experiments: w8a8_matmul time at (M, K, N)={(m, kk, nn)} {layout}: "
            f"{_fmt_times(times)} (library: torch._int_mm alone, no scaling); torch._int_mm "
            f"on a column-major copy of the weight {col_major:.4f} ms (graph); bound "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}); in a graph the kernel beats "
            f"torch._int_mm: {times['graph_ms'] < times['library_graph_ms']}")
        if bn is None:
            k4_graph_ms[(m, kk, nn)] = times["graph_ms"]
        if "w8a8_matmul" not in entries:
            entries["w8a8_matmul"] = {**times, **least}
    entries["w8a8_matmul"]["max_abs_err"] = worst
    # K5: the split-half int4 product, signed and biased, each the same bits
    # on a second call, its grid and S logged; timed at every shape beside
    # K4 at the same shape (the kernels line's entry: M 8 signed)
    for line in kernels.build_log("int4_split_matmul").splitlines():
        if "registers" in line or "spill" in line:
            log(f"kernel-experiments: int4_split_matmul ptxas {line.strip()}")
    worst = 0.0
    for biased in (False, True):
        pack = lowbit.pack_split_half_biased if biased else lowbit.pack_split_half
        kind = "biased" if biased else "signed"
        for m in ROW_MAJOR_M:
            x, q, s = randint((m, k)), randint((k, n), -8, 8), scales(n)
            packed = pack(q)
            out = int4_split_matmul(x, packed, s, biased)
            again = torch.equal(out, int4_split_matmul(x, packed, s, biased))
            worst = max(worst, held(f"int4_split_matmul {kind}", (m, k, n), out,
                                    int4_split_matmul_reference(x, packed, s, biased)))
            held("int4_split_matmul against the dense int4 weight", (m, k, n), out,
                 (x.double() @ q.double()).float() * s)
            blocks = split_grid(m, k, n)
            log(f"kernel-experiments: int4_split_matmul {kind} (M, K, N)={(m, k, n)} same bits "
                f"on a second call {again}; S={blocks[1]} slices of K/2, grid {blocks} (column "
                f"tiles, S, row blocks)")
            if not again:
                raise RuntimeError(f"int4_split_matmul gives other bits on a second call at "
                                   f"{(m, k, n)} {kind}")
            times = _kernel_times(lambda: int4_split_matmul(x, packed, s, biased),
                                  lambda: int4_split_matmul_reference(x, packed, s, biased))
            least = _bound((x, packed, s), (out,), 2 * m * k * n, "int8")
            yardstick = k4_graph_ms[(m, k, n)]
            log(f"kernel-experiments: int4_split_matmul {kind} time at (M, K, N)={(m, k, n)}: "
                f"{_fmt_times(times)}; bound {least['bound_ms']:.5f} ms ({least['bound_by']}); "
                f"K4 at the same shape {yardstick:.4f} ms (graph); in a graph K5 beats K4: "
                f"{times['graph_ms'] < yardstick}")
            if "int4_split_matmul" not in entries:
                entries["int4_split_matmul"] = {**times, **least}
    entries["int4_split_matmul"]["max_abs_err"] = worst
    # K2 at one group: the adjacent-row (bitcast) packing
    for m in ADJACENT_M:
        x, q, s = randint((m, k)), randint((k, n), -8, 8), scales(n)
        packed = pack_int4(q)
        out = lowbit.int4_adjacent_matmul(x, packed, s)
        relaid = to_block_major(packed, lowbit.adjacent_block_width(n))
        held("int4_matmul at one group (adjacent-row packing)", (m, k, n), out,
             int4_matmul_reference(x, relaid, s))
        held("int4_matmul at one group against the dense int4 weight", (m, k, n), out,
             (x.double() @ q.double()).float() * s)
    # K6: the fused GeGLU FFN, its two phases' geometry and ptxas's lines
    m, h, inter = bench_fused_ffn.M, bench_fused_ffn.H, bench_fused_ffn.I
    (rows, i_tiles), (rows2, s, h_tiles) = ffn_grid(m, h, inter)
    log(f"kernel-experiments: fused_ffn (M, H, I)={(m, h, inter)}: phase 1 (gate, up, "
        f"GeGLU) grid {(rows, i_tiles)} (row blocks of 288, column tiles of 64 of I), no "
        f"cluster; phase 2 (down) grid {(rows2, s, h_tiles)} (row blocks, S={s} slices of K, "
        f"column tiles of 64 of H), cluster (1, {s}, 1)")
    clusters = ffn_clusters()
    log(f"kernel-experiments: fused_ffn phase 2 clusters of 1..8 blocks the card runs at once "
        f"{list(clusters[1:])} (the S rule's table for an H100 SXM: {list(FFN_CLUSTERS[1:])})")
    for line in kernels.build_log("fused_ffn").splitlines():
        if "registers" in line or "spill" in line or "serialized" in line:
            log(f"kernel-experiments: fused_ffn ptxas {line.strip()}")
    x = (torch.rand(m, h, generator=g, device=device) * 2 - 1).to(torch.bfloat16)
    weights = bench_fused_ffn.layer_weights(h, inter, g, device)
    out = fused_ffn(x, *weights)
    ref = fused_ffn_reference(x, *weights).float()
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    bound = bench_fused_ffn.BF16_STEP * ref.abs().max().item()
    again = torch.equal(out, fused_ffn(x, *weights))
    log(f"kernel-experiments: fused_ffn (M, H, I)={(m, h, inter)} max_abs_err={err:.3e} (bound "
        f"one bf16 step at the largest output, {bound:.3e}), same bits on a second call "
        f"{again}")
    if not (torch.isfinite(out).all() and err <= bound and again):
        raise RuntimeError(f"fused_ffn disagrees with its plain version: {err}")
    times = _kernel_times(lambda: fused_ffn(x, *weights), lambda: fused_ffn_reference(x, *weights))
    three = _fmt_times(times, lambda: bench_fused_ffn.ffn_bf16(x, *weights),
                       "the three weights (the FFN)")
    log(f"kernel-experiments: fused_ffn time at (M, H, I)={(m, h, inter)}: {three}")
    _ffn_phase_split(lambda: fused_ffn(x, *weights))
    entries["fused_ffn"] = {"max_abs_err": err, **times,
                            **_bound((x, *weights), (out,), 6 * m * h * inter, "bf16")}
    return entries


def _ffn_phase_split(call, calls: int = 10) -> None:
    """K6's device time split between its two kernels (phase 1: gate, up
    and GeGLU; phase 2: the down product and its cluster merge) under
    torch.profiler, per call over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    phases = {("phase 1 (gate, up, GeGLU)" if "<true>" in e.key else "phase 2 (down, merge)"):
              e.self_device_time_total / calls / 1000.0
              for e in prof.key_averages() if "ffn_kernel" in e.key}
    if len(phases) != 2:
        raise RuntimeError(f"the profiler did not see both phases of fused_ffn: {phases}")
    log("kernel-experiments: fused_ffn device time per call under torch.profiler: " +
        ", ".join(f"{name} {ms:.4f} ms" for name, ms in phases.items()) +
        f"; both {sum(phases.values()):.4f} ms")


def experiments_run() -> dict:
    """The two experiment entry points as a user runs them, with the counts
    set to 0 just before; each of their kernels must launch."""
    from blurr_tpu_torch.experiments import bench_fused_ffn, bench_lowbit_matmul

    _zero_counts()
    t0 = time.monotonic()
    if bench_lowbit_matmul.main([]) or bench_fused_ffn.main([]):
        raise RuntimeError("an experiment entry point failed")
    launches = _counts()
    log(f"experiments: both entry points in {time.monotonic() - t0:.2f} s, kernel "
        f"launches {launches}")
    for name in ("w8a8_matmul", "int4_split_matmul", "int4_matmul", "fused_ffn"):
        if not launches[name]:
            raise RuntimeError(f"the experiments never launched {name}")
    return launches


def _kernel_wrappers() -> dict:
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.ops.fused_ffn import fused_ffn
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul
    from blurr_tpu_torch.ops.int4_split_matmul import int4_split_matmul
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul
    from blurr_tpu_torch.ops.w8a8_matmul import w8a8_matmul

    return {"flash_attention": flash_attention, "int4_matmul": int4_matmul,
            "int8_matmul": int8_matmul, "w8a8_matmul": w8a8_matmul,
            "int4_split_matmul": int4_split_matmul, "fused_ffn": fused_ffn}


def _zero_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _serve_requests(server, cfg, label):
    """N_REQUESTS through the port's ActionClient with the kernel counts set
    to 0 just before; returns the image, the proprio, the counts and the
    actions."""
    from blurr_tpu_torch.serving.client import ActionClient

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
        _zero_counts()
        latencies, actions = [], []
        with ActionClient(port=server.port) as client:
            for _ in range(N_REQUESTS):
                t = time.monotonic()
                actions.append(client.predict(image, "put the spoon on the towel", proprio))
                latencies.append((time.monotonic() - t) * 1000.0)
            stats = client.stats()
        launches = _counts()
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
    return image, proprio, launches, actions


def _check_launches(label, launches, per_step):
    """Each kernel of ``per_step`` launched that many times per step; every
    other kernel never."""
    for name in KERNEL_NAMES:
        n = per_step.get(name, 0)
        expected = n * N_REQUESTS
        if name in per_step:
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
    image, proprio, launches, actions = _serve_requests(server, cfg, "serve")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    # 18 layers, the last computes only K/V
    _check_launches("serve", launches,
                    {"flash_attention": n_layers - 1, "int4_matmul": 0, "int8_matmul": 0})
    _step_device_time(server, image, proprio, "serve", "flash_attention")
    return server, cfg, image, proprio, launches, actions


def served_baseline_steps(device) -> dict:
    """bridge.yaml with the baseline preset (fp32, no prefix cache, 10 flow
    steps): every flow step runs the whole joint model, K1's fp32 kernel
    over 281 rows in each of 18 layers. Then the naive step against the
    cached one (the prefix_cache preset's) on the same weights, inputs and
    noise, and both timed in turns."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "baseline")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    log(f"serve-baseline: bridge.yaml baseline preset (use_prefix_kv_cache "
        f"{cfg['use_prefix_kv_cache']}, {model.spec.num_inference_steps} flow steps, "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32}), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params {server.dtype} "
        f"drawn on the card in {time.monotonic() - t0:.2f} s")
    if server.dtype != torch.float32 or server.prefix_cache:
        raise RuntimeError("the baseline preset does not serve the fp32 naive step")
    image, proprio, launches, _ = _serve_requests(server, cfg, "serve-baseline")
    per_step = cfg["joint"]["config"]["num_hidden_layers"] * model.spec.num_inference_steps
    _check_launches("serve-baseline", launches,
                    {"flash_attention": per_step, "int4_matmul": 0, "int8_matmul": 0})
    _step_median(server, image, proprio, "serve-baseline")
    _step_device_time(server, image, proprio, "serve-baseline", "flash_attention")
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    noise = server.noise(0)
    steps = {"naive": lambda: model.infer_action_naive(*inputs, noise),
             "cached": lambda: model.infer_action(*inputs, noise)}
    out = {}
    for name, step in steps.items():
        out[name] = step()
    torch.cuda.synchronize()
    diff = (out["naive"] - out["cached"]).abs().max().item()
    log(f"serve-baseline: naive vs cached (prefix_cache preset) control step, the same "
        f"weights, inputs and noise: max_abs_diff={diff:.3e} (tol {BASELINE_TOL:g})")
    if not (torch.isfinite(out["naive"]).all() and diff <= BASELINE_TOL):
        raise RuntimeError(f"the naive and the cached step disagree: {diff}")
    times = {"naive": [], "cached": []}
    for _ in range(3):
        for name in ("naive", "cached", "cached", "naive"):
            t = time.monotonic()
            steps[name]()
            torch.cuda.synchronize()
            times[name].append((time.monotonic() - t) * 1000.0)
    for name, ts in times.items():
        log(f"serve-baseline: fp32 {name} control step ms median {float(np.median(ts)):.3f} "
            f"min {min(ts):.3f} over {len(ts)} (host clock, synchronized)")
    server.prefix_cache = True  # the prefix_cache rung's device time
    _step_device_time(server, image, proprio, "serve-baseline, cached step", "flash_attention")
    return launches


def served_checkpoint(device, server, cfg, want) -> dict:
    """The blurr server's bf16 weights written as a reference .pt (fp32) to
    a temporary directory; a second server started from that path, the file
    deleted; its parameters and its answers must be the first server's, bit
    for bit (same seed and noise, same kernels)."""
    import shutil

    from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
    from blurr_tpu_torch.serving.server import ActionServer

    model = server.model
    fp32_bytes = 4 * sum(p.numel() for p in model.parameters())
    tmp = tempfile.mkdtemp(prefix="blurr_checkpoint_")
    path = os.path.join(tmp, "pi0.pt")
    try:
        log(f"serve-checkpoint: {shutil.disk_usage(tmp).free} B free in {tmp} for "
            f"{fp32_bytes} B of fp32 weights")
        t0 = time.monotonic()
        save_torch_checkpoint(model, path)
        t_write = time.monotonic() - t0
        size = os.path.getsize(path)
        t0 = time.monotonic()
        loaded = ActionServer(cfg, path, device=device, seed=0)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serve-checkpoint: wrote {size} B ({size / 1e9:.3f} GB) in {t_write:.2f} s; "
        f"ActionServer(cfg, path) loaded it onto the card as {loaded.dtype} in "
        f"{t_load:.2f} s; file deleted")
    if loaded.stats()["checkpoint"] != path:
        raise RuntimeError(f"stats name {loaded.stats()['checkpoint']}, not {path}")
    pairs = list(zip(model.named_parameters(), loaded.model.parameters()))
    if len(pairs) != len(list(model.parameters())) or not all(
            torch.equal(p, q) for (_, p), q in pairs):
        raise RuntimeError("the loaded parameters differ from the written ones")
    _, _, launches, actions = _serve_requests(loaded, cfg, "serve-checkpoint")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches("serve-checkpoint", launches,
                    {"flash_attention": n_layers - 1, "int4_matmul": 0, "int8_matmul": 0})
    same = [np.array_equal(a, b) for a, b in zip(actions, want)]
    log(f"serve-checkpoint: parameters bit-equal to the drawn ones; answers the same bits "
        f"as the drawing server's: {same}")
    if not all(same):
        raise RuntimeError("the checkpoint server answers other bits")
    return launches


def launches_per_step(model, cls) -> int:
    """The launches in one control step of the kernel behind the linears of
    class ``cls``: the prefill runs the vlm and proprio mixtures' 7 linears
    in every layer but the last, where it runs only q, k and v; each flow
    step runs the action encoder's 3 linears and the action mixture's 7
    linears in every layer."""
    qkv = ("q_proj", "k_proj", "v_proj")
    rest = ("o_proj", "gate_proj", "up_proj", "down_proj")
    encoder = ("action_encoder_w1", "action_encoder_w2", "action_encoder_w3")

    def count(mod, attrs):
        return sum(isinstance(getattr(mod, a), cls) for a in attrs)

    prefill = sum(
        sum(count(layer, qkv + rest) for layer in model.joint[n].layers[:-1])
        + count(model.joint[n].layers[-1], qkv)
        for n in ("vlm", "proprio")
    )
    decode = sum(count(layer, qkv + rest) for layer in model.joint["action"].layers)
    return prefill + model.spec.num_inference_steps * (decode + count(model, encoder))


def resident_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()])


def _resident_parts(model) -> dict:
    return {
        "embed_tokens": model.embed_tokens.numel() * model.embed_tokens.element_size(),
        "vlm mixture": resident_bytes(model.joint["vlm"]),
        "action mixture": resident_bytes(model.joint["action"]),
        "action encoder": sum(resident_bytes(getattr(model, f"action_encoder_w{i}"))
                              for i in (1, 2, 3)),
        "siglip": resident_bytes(model.vision_tower),
    }


def _step_median(server, image, proprio, label) -> None:
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    times = []
    for i in range(10):
        t = time.monotonic()
        server._step(*inputs, request_idx=i)  # returns host numpy: synchronized
        times.append((time.monotonic() - t) * 1000.0)
    log(f"{label}: control step ms median {float(np.median(times)):.3f} "
        f"min {min(times):.3f} over {len(times)} (host clock, synchronized)")


def _step_device_time(server, image, proprio, label, *names) -> None:
    """One control step under torch.profiler (CUDA activity only): the
    device time of all its kernels and of those of each of ``names`` (the
    names of the port's kernels, e.g. "int4_matmul")."""
    from torch.profiler import ProfilerActivity, profile

    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    server._step(*inputs, request_idx=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        server._step(*inputs, request_idx=0)
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    shares = []
    for name in names:
        ours = [e for e in kernels if name in e.key]
        ours_ms = sum(e.self_device_time_total for e in ours) / 1000.0
        shares.append(f"{name} {ours_ms:.3f} ms over {sum(e.count for e in ours)} kernels "
                      f"({', '.join(f'{e.key[:48]} x{e.count}' for e in ours)})")
    log(f"{label}: one control step under torch.profiler: device time {total_ms:.3f} ms over "
        f"{sum(e.count for e in kernels)} kernels; of it {'; '.join(shares)}")
    if not total_ms > 0:
        raise RuntimeError("the profiler saw no device time")


def served_w4a8_steps(device) -> dict:
    from blurr_tpu_torch.ops.quant import W4A8Linear
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
    log(f"serve-w4a8: resident bytes by part {_resident_parts(model)}")
    if weights > MAX_W4A8_WEIGHT_BYTES:
        raise RuntimeError(f"resident weights {weights} B over the bound")
    per_step = launches_per_step(model, W4A8Linear)
    if per_step != W4A8_STEP_LAUNCHES:
        raise RuntimeError(f"the pool64 w4a8 step has {per_step} int4 linears, "
                           f"not {W4A8_STEP_LAUNCHES}")
    image, proprio, launches, _ = _serve_requests(server, cfg, "serve-w4a8")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches("serve-w4a8", launches, {"flash_attention": n_layers - 1,
                                             "int4_matmul": per_step, "int8_matmul": 0})
    _step_median(server, image, proprio, "serve-w4a8")
    _step_device_time(server, image, proprio, "serve-w4a8", "int4_matmul", "flash_attention")
    return launches


def served_int8_steps(device, cache_fp: bool) -> dict:
    """bridge_pool64_steps2.yaml at full width: the int8 {q, s} tier
    (``cache_fp=False``) or the preset as shipped (its cached bf16 copy);
    every decode must read an int8 prefix cache."""
    from blurr_tpu_torch.models.pi0 import joint as joint_lib
    from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-int8-cached" if cache_fp else "serve-int8"
    cfg = load_config("config/eval/bridge_pool64_steps2.yaml")
    if cfg["action_quantization"]["cache_fp_weight"] is not True:
        raise RuntimeError("bridge_pool64_steps2.yaml no longer ships cache_fp_weight: true")
    cfg["action_quantization"]["cache_fp_weight"] = cache_fp
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    weights = resident_bytes(model)
    log(f"{label}: bridge_pool64_steps2.yaml, cache_fp_weight={cache_fp}, random "
        f"{server.dtype} weights drawn on the card and quantized there in "
        f"{time.monotonic() - t0:.2f} s; resident parameters and buffers "
        f"{weights} B ({weights / 1e9:.3f} GB), allocated "
        f"{torch.cuda.memory_allocated()} B")
    log(f"{label}: resident bytes by part {_resident_parts(model)}")
    kind = CachedFpLinear if cache_fp else Int8Linear
    if launches_per_step(model, kind) != INT8_STEP_LAUNCHES:
        raise RuntimeError(f"the pool64 int8 step has {launches_per_step(model, kind)} "
                           f"{kind.__name__}s, not {INT8_STEP_LAUNCHES}")
    per_step = launches_per_step(model, Int8Linear)
    cache_dtypes = set()
    real_decode = joint_lib.decode

    def recording_decode(*args, **kwargs):
        cache = args[4]
        cache_dtypes.update(t.dtype for entry in cache for t in entry[:2])
        return real_decode(*args, **kwargs)

    joint_lib.decode = recording_decode
    try:
        image, proprio, launches, _ = _serve_requests(server, cfg, label)
    finally:
        joint_lib.decode = real_decode
    log(f"{label}: prefix cache k/v dtypes read by the decodes {sorted(map(str, cache_dtypes))}")
    if cache_dtypes != {torch.int8}:
        raise RuntimeError(f"the prefix cache is not held as int8: {cache_dtypes}")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches(label, launches, {"flash_attention": n_layers - 1,
                                      "int4_matmul": 0, "int8_matmul": per_step})
    _step_median(server, image, proprio, label)
    _step_device_time(server, image, proprio, label, "int8_matmul", "flash_attention")
    return launches


def model_kernel_vs_plain(server, image, proprio) -> None:
    """One control step on the served weights with and without the kernel;
    then the step's time both ways (host clock around a synchronized step,
    alternating kernel / plain)."""
    model = server.model
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    flash_spec = model.joint_spec
    plain_spec = dataclasses.replace(flash_spec, use_flash_attn=False)

    def step(spec):
        model.joint_spec = spec
        out = model.infer_action(*inputs, server.noise(0))
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


def small_model_vs_cpu(device, quant: str = "", adaptive: str = "") -> None:
    """The small model on the card against the same weights on the CPU;
    with ``quant="w4a8"`` both hold the same w4a8 weights (quantized once,
    on the CPU), vlm and action mixtures through the int4 kernel and
    SigLIP w8a8; with ``quant="int8"`` the action expert is int8 {q, s}
    through the int8 kernel and the prefix cache is int8 (clip 1.0,
    dequantized to bf16). With ``adaptive="adaLN-Zero"`` the action expert
    is adaptive (its gates' weights redrawn, JAX's init leaves them 0), and
    the naive step is held too."""
    from blurr_tpu_torch.models.pi0.joint import AdaptiveLayerscale
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.quant import Int8Linear, W4A8Linear
    from blurr_tpu_torch.presets import apply_preset, load_config

    label, tol = {"": ("small", SMALL_TOL), "w4a8": ("small-w4a8", SMALL_W4A8_TOL),
                  "int8": ("small-int8", SMALL_INT8_TOL)}[quant]
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32, prefix cache, 10 flow steps
    cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
    cfg["joint"]["config"]["use_flash_attn"] = True
    if adaptive:
        label = f"{label}-{adaptive}"
        cfg["action_expert_adaptive_mode"] = adaptive
        for mix in ("proprio", "action"):
            cfg["joint"]["config"]["mixture"][mix]["adaptive_mode"] = adaptive
    if quant == "w4a8":
        cfg["vlm_quantization"] = {"mode": quant, "include_vision": True}
        cfg["action_quantization"] = {"mode": quant, "activation_clip": None}
    elif quant == "int8":
        cfg["action_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                      "cache_fp_weight": False}
        cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                  "dtype": "bfloat16"}
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, AdaptiveLayerscale):
                mod.gamma.weight.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
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
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    # the naive step attends over 85 rows in every layer of every flow step
    flash = {"infer_action": n_layers - 1,
             "infer_action_naive": n_layers * s.num_inference_steps}
    for infer in ("infer_action", "infer_action_naive") if adaptive else ("infer_action",):
        ref = getattr(cpu, infer)(*inputs)
        _zero_counts()
        out = getattr(gpu, infer)(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
        launches = _counts()
        expected = {name: 0 for name in KERNEL_NAMES}
        expected.update({"flash_attention": flash[infer],
                         "int4_matmul": launches_per_step(gpu, W4A8Linear),
                         "int8_matmul": launches_per_step(gpu, Int8Linear)})
        err = (out.cpu() - ref).abs().max().item()
        log(f"{label}: fp32 bridge_tiny widths, prefix 81, {infer}, card vs CPU actions "
            f"max_abs_err={err:.3e} (tol {tol:g}), kernel launches {launches} "
            f"(expected {expected})")
        if not (torch.isfinite(out).all() and err <= tol):
            raise RuntimeError(f"card and CPU disagree on the {label} model: {err}")
        if launches != expected:
            raise RuntimeError(f"the {label} model launched {launches}, not {expected}")
    if quant == "int8":
        _int8_rounding_witness(cpu, gpu, inputs, device)


def _int8_rounding_witness(cpu, gpu, inputs, device) -> None:
    """small-int8's second witness: record the CPU's int8 prefix cache and
    the int8 kernel's inputs, then run the card again giving it the CPU's
    value wherever its own rounds the other way (a cached K/V value to
    another int8 step, a kernel input to another bf16). What is left is the
    fp32 summation order, held to SMALL_TOL."""
    from blurr_tpu_torch.models.pi0 import pizero
    from blurr_tpu_torch.ops import quant

    real_cache, real_mm = pizero._quantize_cache, quant.int8_mm_nd
    caches, xs = [], []
    flips = {"cached K/V values": 0, "kernel inputs": 0}

    def record_cache(cache, clip):
        caches.append(real_cache(cache, clip))
        return caches[-1]

    def record_mm(x, w):
        xs.append(x)
        return real_mm(x, w)

    def repair_cache(cache, clip):
        out = []
        for mine, theirs in zip(real_cache(cache, clip), caches[0]):
            k, v = theirs.k.to(device), theirs.v.to(device)
            flips["cached K/V values"] += int((mine.k != k).sum() + (mine.v != v).sum())
            out.append(mine._replace(k=k, v=v))
        return out

    cpu_xs = iter(xs)

    def repair_mm(x, w):
        theirs = next(cpu_xs).to(device)
        flip = x.bfloat16() != theirs.bfloat16()
        flips["kernel inputs"] += int(flip.sum())
        return real_mm(torch.where(flip, theirs, x), w)

    try:
        pizero._quantize_cache, quant.int8_mm_nd = record_cache, record_mm
        ref = cpu.infer_action(*inputs)
        pizero._quantize_cache, quant.int8_mm_nd = repair_cache, repair_mm
        out = gpu.infer_action(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
    finally:
        pizero._quantize_cache, quant.int8_mm_nd = real_cache, real_mm
    err = (out.cpu() - ref).abs().max().item()
    n_values = sum(e.k.numel() + e.v.numel() for e in caches[0])
    n_inputs = sum(x.numel() for x in xs)
    log(f"small-int8: with the CPU's rounding where the card's differs "
        f"({flips['cached K/V values']} of {n_values} cached K/V values, "
        f"{flips['kernel inputs']} of {n_inputs} kernel inputs) card vs CPU "
        f"max_abs_err={err:.3e} (tol {SMALL_TOL:g})")
    if not (torch.isfinite(out).all() and err <= SMALL_TOL):
        raise RuntimeError(f"card and CPU disagree on the small-int8 model "
                           f"with the roundings repaired: {err}")


# --------------------------------------------------------------------------
# the closed-loop eval path: the agents on the fake env, the in-graph resize,
# the eval CLI
# --------------------------------------------------------------------------

EVAL_TASK = "fake_widowx_carrot_on_plate"
# the batched bf16 step (M = 4 x 277 rows in every GEMM) against the batch-1
# step on each row's inputs and noise: cuBLAS may pick other algorithms at
# the larger M, so the bf16 roundings differ through 27 + 18 layers, as
# between K1 and the plain attention (MODEL_TOL)
BATCHED_TOL = MODEL_TOL
# the in-graph lanczos3 resize of a 480x640 frame to 224 on the card (fp32
# matmuls, TF32 off) against the CPU's, in the normalized pixel values
FRAME_TOL = 1e-5


class _Lines(logging.Handler):
    """Every log record's message from INFO up, in order."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_logged(run):
    """``run()`` with the root logger's INFO records collected; returns
    (its result, the messages)."""
    root, handler = logging.getLogger(), _Lines()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        return run(), handler.lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _eval_cfg(config: str, log_dir: str, **extra):
    from blurr_tpu_torch.presets import apply_preset, load_config

    cfg = load_config(config)
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    cfg["env"]["task"] = EVAL_TASK
    cfg.update({"n_eval_episode": 2, "n_video": 0, "seed": 42, "checkpoint_path": "random",
                "log_dir": log_dir, **extra})
    return cfg


def _recording(agent, real, records: list):
    """``real`` (a dispatch method) that appends each dispatch's (host
    inputs, dispatch index, device output) to ``records``."""

    def recording(inputs):
        idx = agent._step_idx
        out = real(inputs)
        records.append((inputs, idx, out))
        return out

    return recording


def _record_fetches(agent) -> list:
    """The host chunks the agent's ``_fetch`` returns, in order."""
    chunks, real = [], agent._fetch

    def recording(pending):
        chunks.append(real(pending))
        return chunks[-1]

    agent._fetch = recording
    return chunks


def _check_summary(label, lines, episodes: int, rate: float) -> None:
    want = [f"Number of episodes: {episodes}", f"Success rate: {rate}"]
    for line in want:
        if line not in lines:
            raise RuntimeError(f"{label}: the summary line {line!r} is missing")
    log(f"{label}: summary lines {want}")
    for line in lines:
        if line.startswith(("Inference wall-clock", "Async pipeline", "Batched eval",
                            "Allocated device memory after evaluation")):
            log(f"{label}: {line}")


def _check_eval_launches(label, launches, per_step: dict, steps: int) -> None:
    expected = {name: per_step.get(name, 0) * steps for name in KERNEL_NAMES}
    log(f"{label}: kernel launches {launches} (expected {expected}: "
        f"{per_step} per control step x {steps} control steps)")
    if launches != expected:
        raise RuntimeError(f"{label}: launched {launches}, not {expected}")


def _check_bitwise(label, agent, records) -> None:
    """Every dispatched chunk equals ``infer_action`` called directly on the
    same inputs and noise, bit for bit."""
    for inputs, idx, out in records:
        ref = agent.model.infer_action(*agent.device_inputs(inputs), agent.noise(idx, 1))
        if not torch.equal(ref, out):
            raise RuntimeError(f"{label}: dispatch {idx} differs from infer_action: "
                               f"{(ref.float() - out.float()).abs().max().item()}")
    log(f"{label}: all {len(records)} dispatched chunks bit-equal to infer_action called "
        f"directly on the same inputs and noise")


def eval_agent_new(device, label: str, log_dir: str,
                   config: str = "config/eval/bridge.yaml", **extra):
    """EvalAgent on the fake env at full width with random weights drawn on
    the card; fails if its quantization fell back to unquantized weights."""
    from blurr_tpu_torch.agent.eval_agent import EvalAgent

    cfg = _eval_cfg(config, log_dir, **extra)
    t0 = time.monotonic()
    agent, init_lines = _run_logged(lambda: EvalAgent(cfg, device=device))
    torch.cuda.synchronize()
    if any("Quantization failed" in line for line in init_lines):
        raise RuntimeError(f"{label}: the agent fell back to unquantized weights")
    log(f"{label}: {Path(config).name}, blurr preset, act_steps {agent.act_steps}, "
        f"{sum(p.numel() for p in agent.model.parameters()) / 1e9:.3f} B params "
        f"{agent.dtype} drawn on the card in {time.monotonic() - t0:.2f} s")
    return agent


def eval_agent_run(agent, label: str):
    """One run of the agent (2 episodes, 12 env steps each), the counts set
    to 0 just before it; checks the summary lines, K1's launches (and K2's
    under w4a8) and every chunk bit-equal to a direct infer_action. Returns
    the resize rung lines logged and the launches."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    records = []
    agent._dispatch = _recording(agent, type(agent)._dispatch.__get__(agent), records)
    agent._step_idx = 0
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rate, lines = _run_logged(agent.run)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: async pipeline {agent.async_pipeline}")
    rungs = [line for line in lines if line.startswith("lanczos_resize_uint8: the ")]
    if rungs:
        log(f"{label}: resize rung logged: {rungs[0]}")
    _check_summary(label, lines, 2, 0.5)
    log(f"{label}: peak memory {peak} B ({peak / 2**30:.3f} GiB) on {card()}")
    n_layers = agent.cfg["joint"]["config"]["num_hidden_layers"]
    per_step = {"flash_attention": n_layers - 1,
                "int4_matmul": launches_per_step(agent.model, W4A8Linear)}
    _check_eval_launches(label, launches, per_step, agent._step_idx)
    _check_bitwise(label, agent, records)
    return lines, rungs, launches


def eval_agent_blurr(device, log_dir: str):
    agent = eval_agent_new(device, "eval-agent", log_dir, act_steps=4)
    _, rungs, launches = eval_agent_run(agent, "eval-agent")
    if not rungs:
        raise RuntimeError("eval-agent: no resize rung was logged")
    inputs = _first_inputs(agent)
    _agent_step_times("eval-agent", "the agent's control step", lambda: agent._infer(inputs))
    _resize_rungs(agent)
    return agent, launches


def _agent_step_times(label, what: str, step, n: int = AGENT_TIMED_STEPS) -> float:
    """``step()`` (host inputs up, the eager dispatch, the chunk fetched)
    timed n times on the host clock after one untimed call; logs the median,
    min and max beside n and returns the median in ms."""
    step()
    times = []
    for _ in range(n):
        t = time.monotonic()
        step()
        times.append((time.monotonic() - t) * 1000.0)
    median = float(np.median(times))
    log(f"{label}: {what}: median {median:.3f} ms, min {min(times):.3f}, max "
        f"{max(times):.3f} over n={n} (host clock, synchronized by the fetch)")
    return median


def _first_inputs(agent) -> dict:
    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    return agent.env_adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())


def _resize_rungs(agent) -> None:
    """Each rung of the host resize ladder on a fake-env frame, timed on
    the host (median of 20): cv2 where the machine has it, the native
    library (built here), the torch rung."""
    from blurr_tpu_torch import native
    from blurr_tpu_torch.utils import image

    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    frame = obs["image"]
    size = agent.model.vision_cfg["image_size"]
    found = native.library_path().is_file()
    t0 = time.monotonic()
    built = native.available()
    log(f"eval-agent: native rung available={built} ({'found built' if found else 'built'} "
        f"at {native.library_path().relative_to(REPO_ROOT)}, {time.monotonic() - t0:.2f} s "
        f"to build and load); cv2 {getattr(image.cv2, '__version__', None)}")
    rungs = {"torch": lambda: image._torch_rung(frame, size, size)}
    if image.cv2 is not None:
        rungs["cv2"] = lambda: image.cv2.resize(frame, (size, size),
                                                interpolation=image.cv2.INTER_LANCZOS4)
    if built:
        rungs["native"] = lambda: native.lanczos4_resize(frame, (size, size))
    for name, fn in rungs.items():
        times = []
        for _ in range(20):
            t = time.monotonic()
            fn()
            times.append((time.monotonic() - t) * 1000.0)
        log(f"eval-agent: {name} rung {frame.shape[:2]} -> {size}x{size}: median "
            f"{float(np.median(times)):.3f} ms over 20 (host clock)")


def _free() -> None:
    """Release the memory of a dropped agent: its recording wrappers hold
    it in a reference cycle."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def eval_agent_async(agent) -> dict:
    """Phase 14's agent again with the async pipeline on; then one more
    dispatch under torch.cuda.set_sync_debug_mode("warn"): nothing in it may
    synchronize, and its host time is set beside the fetch that waits for
    the device."""
    import warnings

    agent.async_pipeline = True
    lines, _, launches = eval_agent_run(agent, "eval-agent-async")
    if not any(line.startswith("Async pipeline: residual fetch wait") for line in lines):
        raise RuntimeError("eval-agent-async: no residual-fetch line")
    inputs = _first_inputs(agent)
    agent._fetch(agent._dispatch(inputs))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.monotonic()
            pending = agent._dispatch(inputs)
            t_dispatch = time.monotonic() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t0 = time.monotonic()
    agent._fetch(pending)
    t_fetch = time.monotonic() - t0
    # the notice set_sync_debug_mode itself gives when turned on is no sync
    syncs = [str(w.message).splitlines()[0] for w in caught
             if not str(w.message).startswith("Synchronization debug mode is a prototype")]
    log(f"eval-agent-async: one dispatch under set_sync_debug_mode('warn'): "
        f"{len(syncs)} synchronizing operations {syncs[:3]}; dispatch returned in "
        f"{t_dispatch * 1000:.3f} ms, the fetch then waited {t_fetch * 1000:.3f} ms "
        f"(host clock, one dispatch)")
    if syncs:
        raise RuntimeError("eval-agent-async: the dispatch synchronizes the host")
    return launches


def eval_agent_batched(device) -> dict:
    """BatchedEvalAgent, 4 envs in lockstep over 4 episodes; each row of
    every batched chunk against the batch-1 step on that row's inputs and
    noise (BATCHED_TOL)."""

    from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent

    label = "eval-batched"
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        cfg = _eval_cfg("config/eval/bridge.yaml", tmp, act_steps=4, batch_envs=4,
                        n_eval_episode=4)
        agent = BatchedEvalAgent(cfg, device=device)
        records = []
        agent._dispatch_batched = _recording(agent, agent._dispatch_batched, records)
        _zero_counts()
        rate, lines = _run_logged(agent.run)
        torch.cuda.synchronize()
        launches = _counts()
    _check_summary(label, lines, 4, 0.5)
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches(label, launches, {"flash_attention": n_layers - 1}, agent._step_idx)
    err = 0.0
    for slot_inputs, idx, out in records:
        noise = agent.noise(idx, len(slot_inputs))
        for i, inputs in enumerate(slot_inputs):
            ref = agent.model.infer_action(*agent.device_inputs(inputs), noise[i:i + 1])
            err = max(err, (ref[0].float() - out[i].float()).abs().max().item())
    log(f"{label}: {len(records)} batched steps of {len(records[0][0])} rows, each row "
        f"against the batch-1 step on its inputs and noise: max_abs_err={err:.3e} "
        f"(tol {BATCHED_TOL:g})")
    if not err <= BATCHED_TOL:
        raise RuntimeError(f"{label}: batched rows disagree with batch 1: {err}")
    inputs = records[0][0]
    batched = _agent_step_times(label, f"one lockstep round of {len(inputs)} envs",
                                lambda: agent._batched_infer(inputs))
    single = _agent_step_times(label, "one batch-1 step of the same agent",
                               lambda: agent._infer(inputs[0]))
    log(f"{label}: the round of {len(inputs)} costs {batched / single:.3f} batch-1 steps")
    return launches


def eval_agent_w4a8(device, log_dir: str) -> dict:
    """bridge_pool64_w4a8_steps1.yaml through the agent (act_steps 1 as
    shipped): 370 int4 linears per step, no quantization fallback."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    agent = eval_agent_new(device, "eval-agent-w4a8", log_dir,
                           "config/eval/bridge_pool64_w4a8_steps1.yaml")
    _, _, launches = eval_agent_run(agent, "eval-agent-w4a8")
    inputs = _first_inputs(agent)
    _agent_step_times("eval-agent-w4a8", "the agent's control step",
                      lambda: agent._infer(inputs))
    per_step = launches_per_step(agent.model, W4A8Linear)
    if per_step != W4A8_STEP_LAUNCHES:
        raise RuntimeError(f"eval-agent-w4a8: {per_step} int4 linears per step, "
                           f"not {W4A8_STEP_LAUNCHES}")
    return launches


def from_frame(device, agent) -> dict:
    """infer_action_from_frame on the fake env's 480x640 frame on the card:
    the resized, normalized pixel values against the CPU's (FRAME_TOL), and
    the step bit-equal to infer_action on the card's pixel values."""
    from blurr_tpu_torch.utils.image import lanczos_resize

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("from-frame: TF32 is on")
    model = agent.model
    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    inputs = agent.env_adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())
    ids, am, _, pr = agent.device_inputs(inputs)
    frame = torch.from_numpy(obs["image"])[None]
    size = model.vision_cfg["image_size"]

    def normalized(x):
        return (lanczos_resize(x.float(), size, size, 3) / 255.0 - 0.5) / 0.5

    px_card = normalized(frame.to(device))
    err = (px_card.cpu() - normalized(frame)).abs().max().item()
    noise = agent.noise(0, 1)
    _zero_counts()
    out = model.infer_action_from_frame(ids, am, frame.to(device), pr, noise)
    torch.cuda.synchronize()
    launches = _counts()
    ref = model.infer_action(ids, am, px_card.permute(0, 3, 1, 2).to(pr.dtype), pr, noise)
    log(f"from-frame: {tuple(frame.shape)} uint8 frame resized to {size}x{size} on the card "
        f"(lanczos3, fp32, TF32 off): pixel values vs the CPU max_abs_err={err:.3e} (tol "
        f"{FRAME_TOL:g}); the step bit-equal to infer_action on them: "
        f"{torch.equal(out, ref)}; kernel launches {launches}")
    if not err <= FRAME_TOL:
        raise RuntimeError(f"from-frame: the card's resize disagrees with the CPU's: {err}")
    if not torch.equal(out, ref) or out.shape != (1, 4, 7):
        raise RuntimeError("from-frame: the step differs from infer_action")
    n_layers = agent.cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches("from-frame", launches, {"flash_attention": n_layers - 1}, 1)
    return launches


def eval_cli() -> None:
    """The port's eval CLI as a user runs it, in a subprocess on the card:
    exit 0 and both summary lines in its run.log."""
    import subprocess

    with tempfile.TemporaryDirectory(prefix="blurr_cli_") as tmp:
        cmd = [sys.executable, "scripts/eval_pi0_simpler_torch.py", "--task", EVAL_TASK,
               "--checkpoint", "random", "--config",
               "config/eval/bridge_pool64_w4a8_steps1.yaml", "--preset", "blurr",
               "--n-eval-episode", "2", "--log-dir", tmp]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t0
        run_log = Path(tmp) / "run.log"
        text = run_log.read_text() if run_log.is_file() else ""
    log(f"eval-cli: {' '.join(cmd[1:])} -> exit {proc.returncode} in {secs:.1f} s")
    if proc.returncode != 0:
        raise RuntimeError(f"eval-cli failed:\n{proc.stderr[-3000:]}")
    for want in ("Number of episodes: 2", "Success rate: 0.5"):
        if want not in text:
            raise RuntimeError(f"eval-cli: {want!r} missing from run.log")
    if "Quantization failed" in text:
        raise RuntimeError("eval-cli: the agent fell back to unquantized weights")
    for line in text.splitlines():
        if any(k in line for k in ("Number of episodes", "Success rate", "Inference wall",
                                   "Using device", "Allocated device memory", " rung ")):
            log(f"eval-cli: run.log: {line.split(' | ')[-1]}")


def small_agent_vs_cpu(device) -> dict:
    """bridge_tiny.yaml (80-token prefix, so the prefill takes K1), fp32,
    prefix_cache preset: the same weights in an agent on the CPU and one on
    the card, the same summary lines and every chunk within SMALL_TOL."""

    from blurr_tpu_torch.agent.eval_agent import EvalAgent
    from blurr_tpu_torch.presets import apply_preset

    chunks = {}
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        agents = {}
        for where in ("cpu", "card"):
            cfg = _eval_cfg("config/eval/bridge_tiny.yaml", tmp)
            apply_preset(cfg, "prefix_cache")
            cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
            cfg["env"]["adapter"]["max_seq_len"] = 80
            agents[where] = EvalAgent(cfg, device="cpu" if where == "cpu" else device)
        with torch.no_grad():
            for p, q in zip(agents["card"].model.parameters(), agents["cpu"].model.parameters()):
                p.copy_(q)
        results = {}
        for where, agent in agents.items():
            chunks[where] = _record_fetches(agent)
            _zero_counts()
            results[where] = _run_logged(agent.run)
        torch.cuda.synchronize()
        launches = _counts()  # the CPU's run launches no kernel
    summaries = {w: [line for line in lines if line.startswith(("Number of ep", "Success"))]
                 for w, (_, lines) in results.items()}
    err = max(np.abs(a - b).max() for a, b in zip(chunks["card"], chunks["cpu"]))
    log(f"small-agent: bridge_tiny widths, prefix 81, fp32, 10 flow steps, card vs CPU: "
        f"summaries {summaries['card']} / {summaries['cpu']}, {len(chunks['card'])} chunks "
        f"max_abs_err={err:.3e} (tol {SMALL_TOL:g}), card launches {launches}")
    if summaries["card"] != summaries["cpu"] or len(chunks["card"]) != len(chunks["cpu"]):
        raise RuntimeError("small-agent: the card's run differs from the CPU's")
    if not err <= SMALL_TOL:
        raise RuntimeError(f"small-agent: card and CPU chunks disagree: {err}")
    n_layers = agents["card"].cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches("small-agent", launches, {"flash_attention": n_layers - 1},
                         agents["card"]._step_idx)
    return launches


# --------------------------------------------------------------------------
# the text-generation path: Pi-0's text mode, PaliGemma-3B and Gemma from
# safetensors shards, the small text models card against CPU
# --------------------------------------------------------------------------


def _median_ms(times) -> str:
    return f"median {float(np.median(times)):.3f} ms over n={len(times)}"


def _text_prompt(batch: int, q_len: int, n_img: int, image_token: int, seed: int):
    """Image tokens, BOS, random text ids; numpy int64 [batch, q_len]."""
    rng = np.random.RandomState(seed)
    ids = np.full((batch, q_len), image_token, np.int64)
    ids[:, n_img] = 2
    ids[:, n_img + 1:] = rng.randint(3, 256000, (batch, q_len - n_img - 1))
    return ids


def _pi0_text_run(model, ids, px, am=None, timed: bool = False):
    """Pi-0's prefill and TEXT_NEW_TOKENS - 1 greedy decode steps, with the
    counts set to 0 just before; returns the tokens [B, T] (host), the
    launches of the prefill and of the whole run, and the prefill's and
    each decode step's ms (host clock, synchronized, when ``timed``)."""
    _zero_counts()
    t0 = time.monotonic()
    logits, cache, n = model.infer_text_prefill(ids, px, ids.shape[1] + TEXT_NEW_TOKENS, am)
    tok = logits[:, -1].argmax(-1)
    if timed:
        torch.cuda.synchronize()
    t_prefill = (time.monotonic() - t0) * 1000.0
    prefill = _counts()
    toks, steps = [tok], []
    for _ in range(TEXT_NEW_TOKENS - 1):
        t0 = time.monotonic()
        tok, cache, n = model.infer_text_decode_step(tok, cache, n, am)
        if timed:
            torch.cuda.synchronize()
        steps.append((time.monotonic() - t0) * 1000.0)
        toks.append(tok)
    out = torch.stack(toks, 1).cpu().numpy()
    return out, prefill, _counts(), t_prefill, steps


def _pi0_forced_logits(model, ids, px, tokens, am=None) -> torch.Tensor:
    """Pi-0's prefill logits and its decode logits teacher-forced on
    ``tokens`` [B, TEXT_NEW_TOKENS]: fp32 [B, TEXT_NEW_TOKENS, V]."""
    out, cache, n = model.infer_text_prefill(ids, px, ids.shape[1] + TEXT_NEW_TOKENS, am)
    outs = [out]
    for i in range(TEXT_NEW_TOKENS - 1):
        out, cache, n = model.text_decode_logits(tokens[:, i], cache, n, am)
        outs.append(out)
    return torch.cat(outs, 1).float()


def _profile_text(label, what: str, call) -> None:
    """One ``call()`` under torch.profiler (CUDA activity): its device time
    and kernel count beside its host time, which gives the device's busy
    share of that call."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        call()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t0) * 1000.0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    log(f"{label}: {what} under torch.profiler: device time {device_ms:.3f} ms over "
        f"{sum(e.count for e in kernels)} kernels in {host_ms:.3f} ms of host time (the "
        f"device busy {device_ms / host_ms:.1%} of it, profiler on)")


def _check_text_launches(label, prefill, run, n_layers) -> None:
    """K1 once per layer in the prefill, never in a decode step, and no
    other kernel."""
    want = {name: 0 for name in KERNEL_NAMES}
    want["flash_attention"] = n_layers
    if prefill != want or run != want:
        raise RuntimeError(f"{label}: launched {run} ({prefill} in the prefill), not {want}")


def text_pi0(device) -> dict:
    """Pi-0's text mode at the full bridge.yaml width, bf16, with
    joint.config.use_flash_attn set and random weights drawn on the card:
    the prefill (K1 at [B,8,276,256] over the [B,1,296,256] cache, 18
    launches) and 19 decode steps (one query row: the plain attention), at
    batch 1 and at batch 2 with a right-padded row. The K1 route against the
    plain one on the same weights (TEXT_REL_TOL), tokens compared for
    information; the padded row against that row alone, in bf16 for
    information and in fp32 (the same weights), where its teacher-forced
    logits must agree (TEXT_FP32_TOL) and its tokens be the same. Returns
    the launches of every run."""
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config

    label, smi = "text-pi0", card()
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    model = PiZero(cfg, device=device, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{label}: bridge.yaml, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params bf16 drawn on the card in {time.monotonic() - t0:.2f} s")
    s, n_layers = model.spec, cfg["joint"]["config"]["num_hidden_layers"]
    q_len, n_img = cfg["max_seq_len"], cfg["vision"]["config"]["num_image_tokens"]
    size = cfg["vision"]["config"]["image_size"]
    ids = torch.from_numpy(_text_prompt(2, q_len, n_img, s.image_token_index, 0)).to(device)
    am = torch.ones(2, q_len, dtype=torch.int32, device=device)
    am[1, q_len - TEXT_PAD:] = 0
    ids[1, q_len - TEXT_PAD:] = s.pad_token_id
    g = torch.Generator(device=device).manual_seed(1)
    px = torch.rand(2, 3, size, size, generator=g, device=device) * 2 - 1
    totals = {name: 0 for name in KERNEL_NAMES}

    def run(*args, **kwargs):
        out = _pi0_text_run(model, *args, **kwargs)
        _check_text_launches(label, out[1], out[2], n_layers)
        for name in KERNEL_NAMES:
            totals[name] += out[2][name]
        return out

    one = (ids[:1], px[:1].bfloat16())
    run(*one)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    prefills, steps = [], []
    for _ in range(3):
        toks, _, _, t_prefill, t_steps = run(*one, timed=True)
        prefills.append(t_prefill)
        steps += t_steps
    per_token = float(np.median(steps))
    log(f"{label}: batch 1, prompt {q_len}, {TEXT_NEW_TOKENS} tokens: prefill "
        f"{_median_ms(prefills)}; decode per token {_median_ms(steps)}; "
        f"{1000.0 / per_token:.1f} tokens/s in decode; peak memory "
        f"{torch.cuda.max_memory_allocated()} B (host clock, synchronized; on {smi})")
    log(f"{label}: batch 1 tokens {toks[0].tolist()}")
    prompt = model.infer_text_prefill(*one, q_len + TEXT_NEW_TOKENS)
    _profile_text(label, "one prefill at batch 1",
                  lambda: model.infer_text_prefill(*one, q_len + TEXT_NEW_TOKENS))
    _profile_text(label, "one decode step at batch 1", lambda: model.infer_text_decode_step(
        prompt[0][:, -1].argmax(-1), prompt[1], q_len))

    # the K1 route against the plain attention, the same weights; decode
    # teacher-forced on the K1 route's tokens
    forced = torch.from_numpy(toks).to(device)
    flash_spec = model.joint_spec
    logits = {}
    try:
        for route, spec in (("kernel", flash_spec),
                            ("plain", dataclasses.replace(flash_spec, use_flash_attn=False))):
            model.joint_spec = spec
            logits[route] = _pi0_forced_logits(model, *one, forced)
    finally:
        model.joint_spec = flash_spec
    top = logits["kernel"].abs().max().item()
    errs = (logits["kernel"] - logits["plain"]).abs().amax(-1)[0]
    agree = (logits["kernel"].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
    log(f"{label}: K1 route vs plain attention, bf16, the same weights: prefill last logits "
        f"max_abs_diff={errs[0].item():.3e}, teacher-forced decode logits "
        f"max_abs_diff={errs[1:].max().item():.3e}, largest |logit| {top:.3f} (tol "
        f"{TEXT_REL_TOL:g} of it, {TEXT_REL_TOL * top:.3e}); greedy tokens agree at "
        f"{agree:.3f} of {TEXT_NEW_TOKENS} positions (information: random weights tie)")
    if not (torch.isfinite(logits["kernel"]).all() and errs.max().item() <= TEXT_REL_TOL * top):
        raise RuntimeError(f"{label}: the K1 and plain routes disagree: {errs.max().item()}")

    # batch 2, row 1 right-padded, against row 1 alone, the decode
    # teacher-forced on the batch's tokens: bf16 for information, then fp32
    # on the same weights, where the logits must agree within TEXT_FP32_TOL
    # of the largest |logit| and the tokens must be equal (bf16's roundings
    # differ between the two batch shapes)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            model.float()
        batch, _, _, t_prefill, t_steps = run(ids, px.to(dtype), am, timed=True)
        n_valid = q_len - TEXT_PAD
        alone, *_ = run(ids[1:2, :n_valid], px[1:2].to(dtype))
        same = (batch[1] == alone[0]).mean()
        forced = torch.from_numpy(batch).to(device)
        padded = _pi0_forced_logits(model, ids, px.to(dtype), forced, am)[1]
        single = _pi0_forced_logits(model, ids[1:2, :n_valid], px[1:2].to(dtype),
                                    forced[1:2])[0]
        top, diff = single.abs().max().item(), (padded - single).abs().max().item()
        gated = dtype == torch.float32
        log(f"{label}: batch 2 {str(dtype)[6:]}, row 1 padded by {TEXT_PAD}: prefill "
            f"{t_prefill:.3f} ms, decode per token {_median_ms(t_steps)} (host clock, on "
            f"{smi}); row 1's tokens equal to that row alone at {same:.3f} of "
            f"{TEXT_NEW_TOKENS}; its prefill and teacher-forced decode logits against that "
            f"row alone max_abs_diff={diff:.3e}, largest |logit| {top:.3f}, {diff / top:.3e} "
            f"of it" + (f" (tol {TEXT_FP32_TOL:g} of it)" if gated else " (information)"))
        if not (np.isfinite(batch).all() and torch.isfinite(padded).all()):
            raise RuntimeError(f"{label}: the padded batch is not finite")
        if gated and not (same == 1.0 and diff <= TEXT_FP32_TOL * top):
            raise RuntimeError(f"{label}: the padded row differs from that row alone: "
                               f"tokens {same}, logits {diff}")
    log(f"{label}: kernel launches over its {totals['flash_attention'] // n_layers} runs "
        f"{totals}: each prefill launched flash_attention {n_layers} times, no decode "
        f"step launched a kernel")
    del model
    torch.cuda.empty_cache()
    return totals


def _forced_logits(model, prompt, tokens) -> torch.Tensor:
    """A standalone model's ``prompt`` (its prefill's logits, cache and
    length) and its decode logits teacher-forced on ``tokens`` [B, T]:
    fp32 [B, T, V]."""
    out, cache, n = prompt
    outs = [out]
    for i in range(tokens.shape[1] - 1):
        out, cache, n = model.decode_logits(tokens[:, i], cache, n)
        outs.append(out)
    return torch.cat(outs, 1).float()


def text_paligemma(device) -> dict:
    """PaliGemma-3B at google/paligemma-3b-pt-224's widths, bf16 random
    weights drawn on the card, written as two safetensors shards under HF
    keys with a config.json, loaded by load_hf_model into a fresh model:
    the same bits, tokens and teacher-forced logits. generate against
    generate_fused (equal tokens), and generate_fused's device part under
    set_sync_debug_mode("warn"), which must find no synchronizing call and
    end on generate's teacher-forced logits; GemmaForCausalLM on the same
    weights, the same tokens and logits as PaliGemma's stack. Plain attention, no clamp, as in
    JAX: K1 must not launch. Returns the launches of the runs."""
    import shutil
    import warnings

    from torch.nn import functional as F

    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.load import load_hf_model
    from blurr_tpu_torch.models.paligemma.model import (
        GemmaForCausalLM,
        PaliGemmaForConditionalGeneration,
    )
    from blurr_tpu_torch.models.pi0.checkpoint import paligemma_state_dict, save_safetensors

    label, smi = "text-paligemma", card()
    config = PaliGemmaConfig(**PALIGEMMA_3B)
    t0 = time.monotonic()
    drawn = PaliGemmaForConditionalGeneration(config, device=device, dtype=torch.bfloat16)
    drawn.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{label}: google/paligemma-3b-pt-224 widths, "
        f"{sum(p.numel() for p in drawn.parameters()) / 1e9:.3f} B params bf16 drawn on the "
        f"card in {time.monotonic() - t0:.2f} s")
    q_len = 264
    ids = torch.from_numpy(_text_prompt(1, q_len, 256, config.image_token_index, 2)).to(device)
    g = torch.Generator(device=device).manual_seed(3)
    px = (torch.rand(1, 3, 224, 224, generator=g, device=device) * 2 - 1).bfloat16()
    # timed before the files are written: the write's disk traffic would
    # share the host with the eager dispatch
    torch.cuda.reset_peak_memory_stats()
    prefills, steps, fused_ms = [], [], []
    for _ in range(5):
        t0 = time.monotonic()
        logits, cache, n = drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefills.append((time.monotonic() - t0) * 1000.0)
        for _ in range(TEXT_NEW_TOKENS - 1):
            t0 = time.monotonic()
            tok, cache, n = drawn.decode_step(tok, cache, n)
            torch.cuda.synchronize()
            steps.append((time.monotonic() - t0) * 1000.0)
        t0 = time.monotonic()
        drawn.generate_fused(ids, px, TEXT_NEW_TOKENS)
        fused_ms.append((time.monotonic() - t0) * 1000.0)
    per_token = float(np.median(steps))
    log(f"{label}: batch 1, prompt {q_len}, {TEXT_NEW_TOKENS} tokens: prefill "
        f"{_median_ms(prefills)}; decode per token {_median_ms(steps)}, "
        f"{1000.0 / per_token:.1f} tokens/s; generate_fused {_median_ms(fused_ms)}; peak "
        f"memory {torch.cuda.max_memory_allocated()} B (host clock, synchronized; on {smi})")
    _profile_text(label, "one prefill", lambda: drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS))
    _profile_text(label, "one decode step", lambda: drawn.decode_step(tok, cache, q_len))
    tmp = tempfile.mkdtemp(prefix="blurr_paligemma_")
    try:
        state = paligemma_state_dict(drawn.embed_tokens, drawn.vision_tower,
                                     drawn.multi_modal_projector, drawn.vlm)
        keys = list(state)
        shards = [k for k in keys if not k.startswith("language_model.model.layers.")], \
            [k for k in keys if k.startswith("language_model.model.layers.")]
        t0 = time.monotonic()
        for i, part in enumerate(shards):
            save_safetensors({k: state[k] for k in part},
                             os.path.join(tmp, f"model-0000{i + 1}-of-00002.safetensors"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(PALIGEMMA_3B, f)
        t_write = time.monotonic() - t0
        del state
        n_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.monotonic()
        model = load_hf_model(tmp, torch.bfloat16, device)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{label}: wrote {n_bytes} B ({n_bytes / 1e9:.3f} GB) as 2 safetensors shards and "
        f"config.json in {t_write:.2f} s; load_hf_model loaded them onto the card in "
        f"{t_load:.2f} s (host clock, on {smi}); files deleted")
    pairs = list(zip(drawn.named_parameters(), model.parameters()))
    if len(pairs) != len(list(drawn.parameters())) or not all(
            torch.equal(p, q) for (_, p), q in pairs):
        raise RuntimeError(f"{label}: the loaded weights differ from the written ones")
    _zero_counts()
    want = drawn.generate(ids, px, TEXT_NEW_TOKENS)
    host = model.generate(ids, px, TEXT_NEW_TOKENS)
    fused = model.generate_fused(ids, px, TEXT_NEW_TOKENS)
    launches = _counts()
    # random weights repeat one token, so the tokens say little: the logits
    # are compared too, bit for bit (the same operations on the same
    # inputs), teacher-forced on the tokens
    forced = torch.from_numpy(host).to(device)
    drawn_logits = _forced_logits(drawn, drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS), forced)
    loaded_logits = _forced_logits(model, model.prefill(ids, px, q_len + TEXT_NEW_TOKENS),
                                   forced)
    log(f"{label}: tokens {host[0].tolist()}; the loaded model's equal the drawn one's "
        f"{np.array_equal(host, want)}, its prefill and teacher-forced decode logits "
        f"max_abs_diff={(loaded_logits - drawn_logits).abs().max().item():.3e} (gated: the "
        f"same bits); generate_fused equal to generate {np.array_equal(fused, host)}; kernel "
        f"launches {launches} (K1 none: plain attention)")
    if not (np.array_equal(host, want) and np.array_equal(fused, host)
            and torch.equal(loaded_logits, drawn_logits)):
        raise RuntimeError(f"{label}: the loaded model or generate_fused differs")
    if any(launches.values()):
        raise RuntimeError(f"{label}: a kernel launched: {launches}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.monotonic()
            pending, last = model.fused_tokens(ids, px, TEXT_NEW_TOKENS)
            t_dispatch = time.monotonic() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t0 = time.monotonic()
    same = np.array_equal(pending.cpu().numpy(), fused)
    t_wait = time.monotonic() - t0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if not str(w.message).startswith("Synchronization debug mode is a prototype")]
    last_diff = (last.float() - loaded_logits[:, -1]).abs().max().item()
    log(f"{label}: generate_fused before its final copy under set_sync_debug_mode('warn'): "
        f"{len(syncs)} synchronizing operations {syncs[:3]}; dispatched in "
        f"{t_dispatch * 1000:.3f} ms, the copy then waited {t_wait * 1000:.3f} ms (host "
        f"clock, on {smi}); the same tokens {same}; its last step's logits against "
        f"generate's teacher-forced max_abs_diff={last_diff:.3e} (gated: the same bits)")
    if syncs or not same or not torch.equal(last.float(), loaded_logits[:, -1]):
        raise RuntimeError(f"{label}: generate_fused synchronizes or differs")
    del drawn
    gemma = GemmaForCausalLM(config, device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        gemma.embed_tokens.copy_(model.embed_tokens)
    gemma.vlm.load_state_dict(model.vlm.state_dict())
    text = ids[:, 256:]
    t0 = time.monotonic()
    toks = gemma.generate(text, TEXT_NEW_TOKENS)
    t_gemma = (time.monotonic() - t0) * 1000.0
    prompt = model._prefill(F.embedding(text, model.embed_tokens),
                            text.shape[1] + TEXT_NEW_TOKENS)
    ref = model._greedy(*prompt, TEXT_NEW_TOKENS, None)
    forced = torch.from_numpy(ref).to(device)
    stack_logits = _forced_logits(model, model._prefill(
        F.embedding(text, model.embed_tokens), text.shape[1] + TEXT_NEW_TOKENS), forced)
    gemma_logits = _forced_logits(gemma, gemma.prefill(text, text.shape[1] + TEXT_NEW_TOKENS),
                                  forced)
    log(f"{label}: GemmaForCausalLM on the same weights, a {text.shape[1]}-token text prompt: "
        f"{TEXT_NEW_TOKENS} tokens in {t_gemma:.3f} ms (host clock, on {smi}); equal to "
        f"PaliGemma's stack on the same embeddings {np.array_equal(toks, ref)}, its prefill "
        f"and teacher-forced decode logits max_abs_diff="
        f"{(gemma_logits - stack_logits).abs().max().item():.3e} (gated: the same bits)")
    if not (np.array_equal(toks, ref) and torch.equal(gemma_logits, stack_logits)):
        raise RuntimeError(f"{label}: GemmaForCausalLM differs from PaliGemma's stack")
    del model, gemma
    torch.cuda.empty_cache()
    return launches


def small_text_vs_cpu(device) -> dict:
    """A small Pi-0 text model (bridge_tiny widths, fp32, use_flash_attn,
    an 80-token prompt so the prefill takes K1, row 1 right-padded) and a
    small PaliGemma (fp32, plain attention), each on the card against the
    same weights on the CPU: the tokens equal, the logits within SMALL_TOL.
    Returns the card's launches."""
    import copy as copy_lib

    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config

    label = "small-text"
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32
    cfg["joint"]["config"]["use_flash_attn"] = True
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = copy_lib.deepcopy(cpu).to(device)
    s, size = cpu.spec, cfg["vision"]["config"]["image_size"]
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    ids = _text_prompt(2, 80, n_img, s.image_token_index, 4) % s.vocab_size
    ids[:, :n_img] = s.image_token_index
    ids[1, -7:] = s.pad_token_id
    am = np.ones((2, 80), np.int32)
    am[1, -7:] = 0
    px = np.random.RandomState(5).uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    inputs = [torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(am)]

    def logits_and_tokens(model, ids, px, am):
        out, cache, n = model.infer_text_prefill(ids, px, 80 + 10, am)
        logits, toks = [out], [out[:, -1].argmax(-1)]
        for _ in range(9):
            out, cache, n = model.text_decode_logits(toks[-1], cache, n, am)
            logits.append(out)
            toks.append(out[:, -1].argmax(-1))
        return torch.cat(logits, 1).cpu(), torch.stack(toks, 1).cpu()

    ref = logits_and_tokens(cpu, *inputs)
    _zero_counts()
    out = logits_and_tokens(gpu, *(t.to(device) for t in inputs))
    torch.cuda.synchronize()
    launches = _counts()
    err = (out[0] - ref[0]).abs().max().item()
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    log(f"{label}: Pi-0 text, bridge_tiny widths, fp32, prompt 80 (row 1 padded by 7), 10 "
        f"tokens, card vs CPU: logits max_abs_err={err:.3e} (tol {SMALL_TOL:g}), tokens equal "
        f"{torch.equal(out[1], ref[1])}; kernel launches {launches} (expected {n_layers} of "
        f"flash_attention)")
    if not (err <= SMALL_TOL and torch.equal(out[1], ref[1])):
        raise RuntimeError(f"{label}: the card's Pi-0 text differs from the CPU's: {err}")
    if launches != {**{name: 0 for name in KERNEL_NAMES}, "flash_attention": n_layers}:
        raise RuntimeError(f"{label}: launched {launches}")
    config = PaliGemmaConfig(**SMALL_PALIGEMMA)
    cpu = PaliGemmaForConditionalGeneration(config, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(1))
    gpu = copy_lib.deepcopy(cpu).to(device)
    n_img = config.vision_config.num_image_tokens
    ids = _text_prompt(2, n_img + 12, n_img, config.image_token_index, 6) % 998
    ids[:, :n_img] = config.image_token_index
    px = np.random.RandomState(7).uniform(-1, 1, (2, 3, 56, 56)).astype(np.float32)
    ref = cpu.prefill(torch.from_numpy(ids), torch.from_numpy(px), ids.shape[1] + 10)[0]
    out = gpu.prefill(torch.from_numpy(ids).to(device), torch.from_numpy(px).to(device),
                      ids.shape[1] + 10)[0].cpu()
    err = (out - ref).abs().max().item()
    toks_cpu = cpu.generate_fused(ids, px, 10)
    _zero_counts()
    toks_gpu = gpu.generate_fused(ids, px, 10)
    launches_pg = _counts()
    log(f"{label}: PaliGemma, fp32, prompt {ids.shape[1]}, 10 tokens, card vs CPU: prefill "
        f"logits max_abs_err={err:.3e} (tol {SMALL_TOL:g}), generate_fused tokens equal "
        f"{np.array_equal(toks_gpu, toks_cpu)}; kernel launches {launches_pg}")
    if not (err <= SMALL_TOL and np.array_equal(toks_gpu, toks_cpu)):
        raise RuntimeError(f"{label}: the card's PaliGemma differs from the CPU's: {err}")
    if any(launches_pg.values()):
        raise RuntimeError(f"{label}: PaliGemma launched {launches_pg}")
    return launches


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
    kernel_text_vs_plain(device)
    int4 = int4_vs_plain(device)
    int8 = int8_vs_plain(device)
    server, cfg, image, proprio, launches, actions = served_control_steps(device)
    model_kernel_vs_plain(server, image, proprio)
    checkpoint_launches = served_checkpoint(device, server, cfg, actions)
    del server
    torch.cuda.empty_cache()
    small_model_vs_cpu(device)
    baseline_launches = served_baseline_steps(device)
    torch.cuda.empty_cache()
    small_model_vs_cpu(device, adaptive="adaLN-Zero")
    w4a8_launches = served_w4a8_steps(device)
    torch.cuda.empty_cache()
    small_model_vs_cpu(device, "w4a8")
    int8_launches = served_int8_steps(device, cache_fp=False)
    torch.cuda.empty_cache()
    cached_launches = served_int8_steps(device, cache_fp=True)
    torch.cuda.empty_cache()
    small_model_vs_cpu(device, "int8")
    experiments = experiments_vs_plain(device)
    torch.cuda.empty_cache()
    experiment_launches = experiments_run()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        agent, eval_launches = eval_agent_blurr(device, tmp)
        frame_launches = from_frame(device, agent)
        async_launches = eval_agent_async(agent)
        del agent
        _free()
        batched_launches = eval_agent_batched(device)
        _free()
        eval_w4a8_launches = eval_agent_w4a8(device, tmp)
        _free()
    eval_cli()
    small_agent_launches = small_agent_vs_cpu(device)
    _free()
    text_pi0_launches = text_pi0(device)
    text_paligemma_launches = text_paligemma(device)
    small_text_launches = small_text_vs_cpu(device)
    runs = (launches, checkpoint_launches, baseline_launches, w4a8_launches, int8_launches,
            cached_launches, experiment_launches, eval_launches, frame_launches,
            async_launches, batched_launches, eval_w4a8_launches, small_agent_launches,
            text_pi0_launches, text_paligemma_launches, small_text_launches)
    total = {name: sum(run[name] for run in runs) for name in KERNEL_NAMES}
    measured = {"flash_attention": flash, "int4_matmul": int4, "int8_matmul": int8,
                **experiments}
    # the TPU kernel each replaces (file:line of its kernel body); K2 also
    # replaces the bitcast int4 kernels of the experiments, at one group
    replaces = {
        "flash_attention": "blurr_tpu/ops/pallas_attention.py:40",
        "int4_matmul": "blurr_tpu/ops/pallas_int4_matmul.py:109",
        "int8_matmul": "blurr_tpu/ops/pallas_int8_matmul.py:30",
        "w8a8_matmul": "experiments/bench_pallas_int4.py:37",
        "int4_split_matmul": "experiments/bench_pallas_int4.py:42",
        "fused_ffn": "experiments/bench_fused_ffn.py:32",
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"blurr_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": total[name], **measured[name]}
        for name in KERNEL_NAMES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
