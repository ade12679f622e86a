#!/usr/bin/env python3
"""K1's fp32 kernel beside variants of itself on the card: where its time
goes and what each of its choices buys.

    python scripts/ablate_flash_fp32_torch.py

Each variant is the kernel's source (``blurr_tpu_torch/csrc/flash_attention.cu``)
with text substitutions, built by nvcc into a directory of its own under
``blurr_tpu_torch/_build/ablate/`` and called through ctypes:

- ``kernel``: as it is;
- ``cvt_rna``: the TF32 rounding by ``cvt.rna.tf32.f32`` in place of the
  two integer operations;
- ``tanhf``: the clamp as ``tanhf(z / softclamp)``;
- ``one_accumulator``: S's small products into the hi hi accumulator;
- ``one_product``: both products hi hi alone (a plain TF32 kernel);
- ``no_products``: no ``mma`` at all (the time of everything else);
- ``no_clamp`` and ``no_mask``: the kernel called with the clamp off and
  without a mask.

Prints each variant's largest error against the plain version (TF32 off;
the two ``no_`` call variants against the plain version called the same
way) with q and k x0.3 and x1.0, and its time in a CUDA graph (the lesser
of two runs taken in turns: every variant, then in reverse), at the naive
step's [1,8,281,256] and a batched baseline bucket [4,8,281,256], beside
the plain version's, with the card's name and power limit; then one JSON
line of all of it. The inputs are ``chip_smoke.py``'s. Needs a Hopper card
and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

SOURCE = REPO_ROOT / "blurr_tpu_torch" / "csrc" / "flash_attention.cu"
BUILD = REPO_ROOT / "blurr_tpu_torch" / "_build" / "ablate"

_INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_CVT_ROUND = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
              "  return r;")
_CLAMP = "if (clamp) z = tanh_fp32(z * inv_clamp) * softclamp;"
_S_MMA = ("        mma_tf32(s_lo[j], al, bh0, bh1);\n"
          "        mma_tf32(s_lo[j], ah, bl0, bl1);\n"
          "        mma_tf32(s[j], ah, bh0, bh1);\n")
_PV_MMA = "        mma_3xtf32(o[c], ph, pl, bh0, bh1, bl0, bl1);\n"

# name: (substitutions of the source, softclamp, mask)
VARIANTS = {
    "kernel": ((), 50.0, True),
    "cvt_rna": (((_INT_ROUND, _CVT_ROUND),), 50.0, True),
    "tanhf": (((_CLAMP, "if (clamp) z = tanhf(z / softclamp) * softclamp;"),), 50.0, True),
    "one_accumulator": (((_S_MMA, "        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);\n"),),
                        50.0, True),
    "one_product": (((_S_MMA, "        mma_tf32(s[j], ah, bh0, bh1);\n"),
                     (_PV_MMA, "        mma_tf32(o[c], ph, bh0, bh1);\n")), 50.0, True),
    "no_products": (((_S_MMA, ""), (_PV_MMA, "")), 50.0, True),
    "no_clamp": ((), None, True),
    "no_mask": ((), 50.0, False),
}


def build(name: str) -> tuple[str, Path, str]:
    """Writes and compiles variant ``name``; returns its library and the
    ptxas lines of its head_dim 256 kernels."""
    from blurr_tpu_torch.ops.kernels import NVCC_FLAGS, find_nvcc

    src = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    out = BUILD / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(src)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out / "lib.so"),
                           str(out / "flash_attention.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    return name, out / "lib.so", regs[0] if regs else ""


def main() -> dict:
    import torch

    import chip_smoke
    from blurr_tpu_torch.experiments.timing import card, graph_ms
    from blurr_tpu_torch.ops.flash_attention import flash_attention_reference

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, path, regs in built:
        lib = ctypes.CDLL(str(path))
        lib.blurr_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
        lib.blurr_flash_attention.restype = i
        libs[name] = lib
        print(f"{name}: ptxas {regs}", flush=True)

    def run(name, q, k, v, mask, out):
        _, softclamp, with_mask = VARIANTS[name]
        b, nh, sq, d = q.shape
        err = libs[name].blurr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr() if with_mask else None,
            out.data_ptr(), b, nh, k.shape[1], sq, k.shape[2], d, 0, d**-0.5,
            softclamp or 0.0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")

    smi = card()
    result = {"card": smi, "shapes": {}}
    for shape in (chip_smoke.NAIVE_SHAPE, chip_smoke.BASELINE_BUCKET_SHAPE):
        errors = {name: {} for name in libs}
        for qk_scale in (0.3, 1.0):
            q, k, v, mask = chip_smoke._attention_inputs(shape, device, qk_scale)
            for name in libs:
                _, softclamp, with_mask = VARIANTS[name]
                ref = flash_attention_reference(q, k, v, mask if with_mask else None, softclamp)
                out = torch.empty_like(q)
                run(name, q, k, v, mask, out)
                torch.cuda.synchronize()
                errors[name][qk_scale] = (out - ref).abs().max().item()
        q, k, v, mask = chip_smoke._attention_inputs(shape, device)
        out = torch.empty_like(q)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(graph_ms(lambda: run(name, q, k, v, mask, out)))
        plain = graph_ms(lambda: flash_attention_reference(q, k, v, mask))
        for name in libs:
            print(f"{list(shape)} {name}: graph ms {min(times[name]):.4f} "
                  f"({', '.join(f'{t:.4f}' for t in times[name])}); max_abs_err x0.3 "
                  f"{errors[name][0.3]:.3e}, x1.0 {errors[name][1.0]:.3e}; on {smi}", flush=True)
        print(f"{list(shape)} plain version: graph ms {plain:.4f}; on {smi}", flush=True)
        result["shapes"][str(list(shape))] = {
            "plain_graph_ms": plain,
            **{name: {"graph_ms": min(times[name]), "max_abs_err": errors[name]}
               for name in libs}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
