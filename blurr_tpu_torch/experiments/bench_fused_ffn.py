"""The fused GeGLU FFN experiment on the card: the port's counterpart of the
``main()`` of ``experiments/bench_fused_ffn.py``.

    python -m blurr_tpu_torch.experiments.bench_fused_ffn            # the card
    python -m blurr_tpu_torch.experiments.bench_fused_ffn --device cpu --small

At the harness's prefill shape (M 280 rows, H 2048, I 16384, bf16), with
weights drawn from a seeded generator on the device:
- one layer: the fused kernel K6 (``ops/fused_ffn.py``) held within one bf16
  step at the largest output of its plain version (fp32 dots, ``a`` rounded
  to bf16), then timed beside the harness's comparison, the three-matmul
  FFN in bf16 (``torch.matmul``, as the port's model computes it), with CUDA
  events and inside a CUDA graph;
- 18 distinct layers (3.6 GB of bf16 weights), each layer's output the next
  one's input, the kernel against the three-matmul FFN, the same two ways.
The harness's ``block_i`` sweep is a TPU tuning knob and has no
counterpart. Every time is printed with the card's name and power limit.

``--device cpu`` runs the plain versions and prints no time (for the
tests); ``--small`` cuts H to 256 and I to 1024 (a CPU size).
"""

from __future__ import annotations

import argparse
import sys

import torch

from blurr_tpu_torch.experiments.timing import bound, card, events_ms, graph_ms
from blurr_tpu_torch.ops.activations import geglu
from blurr_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_reference

M, H, I = 280, 2048, 16384  # the prefill rows (277 padded), Gemma's widths
LAYERS = 18
SEED = 0
# the kernel against its plain version: both round a to bf16 and the output
# to bf16 after fp32 sums taken in another order, so an output may land on
# the neighbouring bf16, at most 2^-7 of the value away (8 significant
# bits); bounded at the largest output
BF16_STEP = 2.0**-7


def ffn_bf16(x, wg, wu, wd):
    """The harness's xla_ffn: three bf16 matmuls and the GeGLU in bf16."""
    return geglu(x @ wg, x @ wu) @ wd


def layer_weights(h, inter, g, device):
    """Wg, Wu [H, I] and Wd [I, H], bf16, N(0, 0.02^2)."""
    def draw(*shape):
        return (torch.randn(*shape, generator=g, device=device) * 0.02).to(torch.bfloat16)
    return draw(h, inter), draw(h, inter), draw(inter, h)


def check(x, weights) -> tuple:
    """The kernel against its plain version on one layer; returns the
    largest difference, which must stay within one bf16 step at the largest
    output, and the kernel's output."""
    out = fused_ffn(x, *weights)
    got, want = out.float(), fused_ffn_reference(x, *weights).float()
    err = (got - want).abs().max().item()
    tol = BF16_STEP * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol):
        raise RuntimeError(f"fused_ffn: {err} from its plain version (bound {tol})")
    return err, out


def chain(fn, x, layers):
    """The layers applied in order, each output the next input."""
    def run():
        h = x
        for w in layers:
            h = fn(h, *w)
        return h
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--small", action="store_true", help="CPU-sized H and I, for the tests")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    timed = device.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("bench_fused_ffn: no CUDA device (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 dots
    where = card() if timed else "cpu, plain versions, no times"
    h, inter = (256, 1024) if args.small else (H, I)
    g = torch.Generator(device=device).manual_seed(SEED)
    x = (torch.rand(M, h, generator=g, device=device) * 2 - 1).to(torch.bfloat16)
    layers = [layer_weights(h, inter, g, device) for _ in range(LAYERS)]
    layer_bytes = sum(t.numel() * t.element_size() for t in layers[0])
    print(f"card: {where}", flush=True)
    err, out = check(x, layers[0])
    least = bound((x, *layers[0]), (out,), 6 * M * h * inter, "bf16")
    print(f"fused_ffn K6 (M, H, I)=({M}, {h}, {inter}): max_abs_err {err:.3e} from its plain "
          f"version (bound one bf16 step at the largest output); least time per layer "
          f"{least['bound_ms']:.4f} ms ({least['bound_by']}, H100 SXM data sheet)", flush=True)
    if not timed:
        return 0
    one = ((lambda: fused_ffn(x, *layers[0])), (lambda: ffn_bf16(x, *layers[0])))
    many = (chain(fused_ffn, x, layers), chain(ffn_bf16, x, layers))
    for n_layers, (fused, plain), iters in ((1, one, 20), (len(layers), many, 3)):
        times = {name: (events_ms(fn, iters=iters, warmup=2), graph_ms(fn, launches=2, replays=3))
                 for name, fn in (("fused kernel", fused), ("three bf16 matmuls", plain))}
        line = "; ".join(f"{name} {ev:.4f} ms (CUDA events), {gr:.4f} ms (CUDA graph)"
                         for name, (ev, gr) in times.items())
        print(f"fused_ffn {n_layers} layer(s) (M, H, I)=({M}, {h}, {inter}), "
              f"{n_layers * layer_bytes / 1e9:.3f} GB of weights: {line} [{where}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
