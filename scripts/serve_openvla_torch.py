#!/usr/bin/env python3
"""Run the OpenVLA-family action server of the PyTorch port (blurr_tpu_torch).

    python scripts/serve_openvla_torch.py --model-id /path/to/openvla-snapshot \\
        --unnorm-key bridge_orig --port 8788

The port's counterpart of scripts/serve_openvla.py, with its flags plus
--device (default cuda; --device cpu runs the plain versions of the
kernels, e.g. --device cpu --model-id random for a tiny random model). With
no card and no --device cpu it fails on its first CUDA call: nothing falls
back to the CPU. --model-id random-7b / random-minivla draw OpenVLA-7B's or
MiniVLA's full widths on the card; --quantization w4a8 sends every LLM
product through the port's int4 kernel. Clients: the port's
blurr_tpu_torch.serving.client.ActionClient (or the JAX package's, the same
wire bytes): .predict(image_u8_hw3, instruction, proprio) -> [action_dim]
actions (normalized [-1, 1] unless --unnorm-key; OFT: a [chunk-len,
action_dim] chunk). --max-batch, --batch-window-ms, --bucket-mode and
--max-queue are dynamic batching's, as in scripts/serve_pi0_torch.py
(ragged prompts co-batch: each answer is its request's alone).
--checkpoint DIR serves a scripts/train_openvla_lora_torch.py --save-params
tree (--model-id still gives the spec, the tokenizer and the statistics;
its adapters run unmerged over its quantized bases), and
scripts/serve_ctl_torch.py reload DIR swaps another one in while serving.
--tp N splits the weights over N ranks (tensor parallelism: LLaMA's heads,
MLP, head and embedding, SigLIP's MLP), --dp N splits each dynamic batch
over N ranks (data parallelism: a power of 2, --max-batch >= N); one
process per rank, this one rank 0 (blurr_tpu_torch/parallel/mesh.py: gloo
on the CPU or where ranks share a card, nccl where each has its own). On
the CPU: --device cpu --tp 2; on one card, the same without --device cpu
(two ranks then share cuda:0 over gloo).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-id", type=str, default="random",
                   help="HF snapshot dir, or random / random-7b / random-minivla")
    p.add_argument("--quantization", type=str, default=None,
                   choices=[None, "w8a8", "w4a8"])
    p.add_argument("--unnorm-key", type=str, default=None,
                   help="norm-stats key for host-side unnormalization")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8788)
    p.add_argument("--seed", type=int, default=42,
                   help="generator seed of a random model id's weights")
    p.add_argument("--max-batch", type=int, default=1)
    p.add_argument("--batch-window-ms", type=float, default=2.0)
    p.add_argument("--bucket-mode", type=str, default="pow2", choices=["pow2", "max"])
    p.add_argument("--max-queue", type=int, default=0)
    p.add_argument("--decode", type=str, default="ar", choices=["ar", "jacobi"],
                   help="jacobi: Jacobi decoding (the AR tokens; each sweep reads the "
                        "weights once). Ignored with --oft.")
    p.add_argument("--max-text-tokens", type=int, default=32)
    p.add_argument("--oft", action="store_true",
                   help="serve OFT's parallel decoding: one forward -> a continuous "
                        "[chunk-len, action_dim] chunk; loads action_head--*_checkpoint.pt "
                        "from the snapshot dir when present.")
    p.add_argument("--chunk-len", type=int, default=8)
    p.add_argument("--use-proprio", action="store_true",
                   help="OFT: condition on the request's proprio field.")
    p.add_argument("--proprio-dim", type=int, default=8)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel over a (dp, tp) mesh — the capacity "
                        "path for the 7B on cards too small to hold it.")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel batch split (power of 2, requires "
                        "--max-batch >= dp).")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on: cuda (default), cuda:1, or cpu "
                        "(the plain versions of the kernels)")
    return p.parse_args(argv)


def build_server(args):
    from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer

    return OpenVLAActionServer(
        args.model_id, quantization=args.quantization, unnorm_key=args.unnorm_key,
        use_bf16=not args.no_bf16, seed=args.seed, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, tp=args.tp, dp=args.dp,
        max_text_tokens=args.max_text_tokens, oft=args.oft, chunk_len=args.chunk_len,
        use_proprio=args.use_proprio, proprio_dim=args.proprio_dim,
        checkpoint_path=args.checkpoint or None, max_queue=args.max_queue,
        decode=args.decode, bucket_mode=args.bucket_mode, device=args.device,
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    server = build_server(args)
    logging.info("warmup took %.1f s", server.warmup())
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
