"""The low-bit matmul experiments on the card: the port's counterpart of the
``main()`` of ``experiments/bench_pallas_int4.py``, ``_tune.py`` to
``_tune6.py``, ``_dbuf.py`` and ``bench_pallas_int8_blockmajor.py``.

    python -m blurr_tpu_torch.experiments.bench_lowbit_matmul          # the card
    python -m blurr_tpu_torch.experiments.bench_lowbit_matmul --device cpu --small

Each function the harnesses try on the TPU runs here through its kernel, at
the harnesses' shapes, over L = 4 layers of distinct weights drawn from a
seeded generator on the device (scales 1, as the harnesses):
- the w8a8 product through K4 (``ops/w8a8_matmul.py``): row-major at M 8 and
  32 (tune), K 4096, N 11264; block-major at (96, 2048, 16384),
  (96, 16384, 2048), (276, 2048, 16384) and (5, 1024, 4096);
- the split-half int4 product, signed and biased, through K5
  (``ops/int4_split_matmul.py``) at M 8 and 32;
- the adjacent-row (bitcast) int4 product through K2 at one group
  (``experiments/lowbit.py``) at M 8, 32 and 96 (tune6), the row-major
  weight re-laid block-major once;
- ``torch._int_mm`` on the int8 weight (``ops/quant.py:int8_dot``, rows
  padded to 32), the harnesses' "xla-int8" comparator.
Every kernel is first held bit for bit against its plain version on the
first layer. Times per layer: CUDA events around eager launches, and inside
one CUDA graph over the L layers; with the card's name and power limit. The
TPU tuning knobs of the harnesses (block_n sweeps, vmem limits, cost
estimates, unpacking variants, manual DMA) have no counterpart: they are
ways to implement the same function on a TPU.

``--device cpu`` runs the plain versions and prints no time (for the tests);
``--small`` cuts K to 256 (K/8 for the block-major shapes) and N 11264 to
2816, a CPU size.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import torch

from blurr_tpu_torch.experiments import lowbit
from blurr_tpu_torch.experiments.timing import bound, card, events_ms, graph_ms
from blurr_tpu_torch.ops.int4_matmul import (
    from_block_major,
    int4_matmul,
    int4_matmul_reference,
    pack_int4,
    to_block_major,
)
from blurr_tpu_torch.ops.int4_split_matmul import int4_split_matmul, int4_split_matmul_reference
from blurr_tpu_torch.ops.quant import int8_dot
from blurr_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_reference

K, NP = 4096, 11264  # the harnesses' K and N (11008 padded to 512)
LAYERS = 4
ROW_MAJOR_M = (8, 32)  # bench_pallas_int4.py (8) and _tune.py (8, 32)
ADJACENT_M = (8, 32, 96)  # _tune2 to _tune5 and _dbuf (8), _tune6 (8, 96)
# (M, K, N) of bench_pallas_int8_blockmajor.py: pool64 gate/up and down,
# bridge gate/up, decode; block_n 2048 where it divides N, else 1024
BLOCK_MAJOR = ((96, 2048, 16384), (96, 16384, 2048), (276, 2048, 16384), (5, 1024, 4096))
SEED = 0


def block_major_width(n: int) -> int:
    return 2048 if n % 2048 == 0 else 1024


def _randint(shape, low, high, g, device):
    return torch.randint(low, high, shape, dtype=torch.int8, device=device, generator=g)


@dataclasses.dataclass
class Case:
    """One function at one harness shape, over LAYERS layers."""

    name: str
    shape: tuple  # (M, K, N)
    kernel: Callable  # the wrapper that launches the kernel
    plain: Callable  # its plain version
    operands: list  # the kernel's arguments, one tuple per layer
    weight_bytes: int  # per layer
    int8_operands: Optional[list] = None  # torch._int_mm's (x, w) per layer
    entry: Optional[Callable] = None  # the port's entry point, if not ``kernel``


def _adjacent_entry(x, packed_bm, s):
    """``lowbit.int4_adjacent_matmul`` on the row-major weight the harness
    holds: it re-lays it block-major and launches K2."""
    return lowbit.int4_adjacent_matmul(x, from_block_major(packed_bm), s)


def cases(device, small: bool = False) -> list:
    """Every function at its harness shapes; ``small`` cuts K and N to a
    CPU size."""
    g = torch.Generator(device=device).manual_seed(SEED)
    k_full, n_full = (256, 2816) if small else (K, NP)
    out = []
    for m in ROW_MAJOR_M:
        x = _randint((m, k_full), -127, 128, g, device)
        s = torch.ones(1, n_full, device=device)
        w8 = [_randint((k_full, n_full), -127, 128, g, device) for _ in range(LAYERS)]
        q4 = [_randint((k_full, n_full), -8, 8, g, device) for _ in range(LAYERS)]
        shape = (m, k_full, n_full)
        out.append(Case("w8a8 K4 row-major", shape, w8a8_matmul, w8a8_matmul_reference,
                        [(x, w, s) for w in w8], k_full * n_full, [(x, w) for w in w8]))
        for biased, pack in ((False, lowbit.pack_split_half), (True, lowbit.pack_split_half_biased)):
            name = f"int4 split-half {'biased' if biased else 'signed'} K5"
            packed = [pack(q) for q in q4]
            out.append(Case(name, shape, lambda x, p, s, b=biased: int4_split_matmul(x, p, s, b),
                            lambda x, p, s, b=biased: int4_split_matmul_reference(x, p, s, b),
                            [(x, p, s) for p in packed], k_full * n_full // 2))
    bn = lowbit.adjacent_block_width(n_full)
    q4 = [_randint((k_full, n_full), -8, 8, g, device) for _ in range(LAYERS)]
    packed = [to_block_major(pack_int4(q), bn) for q in q4]
    for m in ADJACENT_M:
        x = _randint((m, k_full), -127, 128, g, device)
        s = torch.ones(1, n_full, device=device)
        out.append(Case("int4 adjacent (bitcast) K2 at one group", (m, k_full, n_full),
                        int4_matmul, int4_matmul_reference, [(x, p, s) for p in packed],
                        k_full * n_full // 2, entry=_adjacent_entry))
    for m, k, n in BLOCK_MAJOR:
        if small:
            k //= 8
        x = _randint((m, k), -127, 128, g, device)
        s = torch.ones(1, n, device=device)
        w8 = [_randint((k, n), -127, 128, g, device) for _ in range(LAYERS)]
        bm = [lowbit.int8_block_major(w, block_major_width(n)) for w in w8]
        out.append(Case("w8a8 K4 block-major", (m, k, n), w8a8_matmul, w8a8_matmul_reference,
                        [(x, w, s) for w in bm], k * n, [(x, w) for w in w8]))
    return out


def check(case: Case) -> torch.Tensor:
    """The entry point on the first layer, bit for bit against the plain
    version; returns its output."""
    got = (case.entry or case.kernel)(*case.operands[0])
    want = case.plain(*case.operands[0])
    if not torch.equal(got, want):
        err = (got - want).abs().max().item()
        raise RuntimeError(f"{case.name} {case.shape}: the kernel is not its plain version "
                           f"(max {err})")
    return got


def time_layers(fn, operands) -> tuple:
    """(ms per layer with CUDA events, ms per layer in a CUDA graph) of
    ``fn`` over the layers' operands."""
    def all_layers():
        for ops in operands:
            fn(*ops)
    n = len(operands)
    return events_ms(all_layers, iters=20) / n, graph_ms(all_layers, launches=5) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--small", action="store_true", help="CPU-sized K and N, for the tests")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    timed = device.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("bench_lowbit_matmul: no CUDA device (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    where = card() if timed else "cpu, plain versions, no times"
    print(f"card: {where}", flush=True)
    for case in cases(device, args.small):
        out = check(case)
        m, k, n = case.shape
        least = bound(case.operands[0], (out,), 2 * m * k * n, "int8")
        line = (f"{case.name} (M, K, N)={case.shape}: bit-equal to its plain version; bound "
                f"{least['bound_ms']:.4f} ms/layer ({least['bound_by']}, H100 SXM data sheet)")
        if timed:
            ev, gr = time_layers(case.kernel, case.operands)
            line += (f"; {ev:.4f} ms/layer (CUDA events), {gr:.4f} ms/layer (CUDA graph, "
                     f"L={len(case.operands)}), {case.weight_bytes / gr / 1e6:.1f} GB/s of weight")
            if case.int8_operands is not None:
                ev, gr = time_layers(int8_dot, case.int8_operands)
                line += (f"; torch._int_mm (xla-int8) {ev:.4f} / {gr:.4f} ms/layer, "
                         f"{k * n / gr / 1e6:.1f} GB/s")
            line += f" [{where}]"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
