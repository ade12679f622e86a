#!/usr/bin/env python3
"""Host time per call of a w8a8 or w4a8 linear on the card, called as the
servers call it (no gradients), kernel included.

    python scripts/time_quant_linear_torch.py --tier w4a8 --m 1 --k 4096 --n 4224

Random weights from seed 0, quantized by the tier's quantizer; CALLS
calls in a row, synchronized once at the end, --rounds times; prints one
JSON line with the median and the minimum microseconds per call, the
card's name and its power limit. Run it from two checkouts in one session
(parent, change, change, parent) to compare their per-call host cost.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

CALLS = 1575  # the quantized products of one OpenVLA-7B w4a8 request


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tier", choices=("w8a8", "w4a8"), default="w4a8")
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--k", type=int, default=4096)
    p.add_argument("--n", type=int, default=4224)
    p.add_argument("--rounds", type=int, default=9)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from blurr_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(args.k, args.n, generator=g, device="cuda") * 0.02
    make = {"w8a8": lambda: quant.W8A8Linear(**quant.quantize_weight_w8a8(w)),
            "w4a8": lambda: quant.W4A8Linear(**quant.quantize_weight_w4a8(w))}[args.tier]
    lin = make()
    x = torch.randn(args.m, args.k, generator=g, device="cuda", dtype=torch.bfloat16)
    us = []
    with torch.no_grad():
        for _ in range(3):
            lin(x)
        torch.cuda.synchronize()
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                lin(x)
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) / CALLS * 1e6)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"tier": args.tier, "shape": [args.m, args.k, args.n], "calls": CALLS,
           "rounds": args.rounds, "us_per_call_median": float(np.median(us)),
           "us_per_call_min": float(min(us)), "card": card.strip().splitlines()[0]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
