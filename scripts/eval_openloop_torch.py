#!/usr/bin/env python3
"""Open-loop action evaluation of a Pi-0 checkpoint over a recorded dataset
with the PyTorch port (blurr_tpu_torch).

    python scripts/eval_openloop_torch.py --config config/eval/bridge.yaml \\
        --checkpoint random --data synthetic --examples 64 --use-bf16

The port's counterpart of scripts/eval_openloop.py, with its flags, metrics,
printed lines and final JSON line, plus --device (default cuda; --device cpu
runs the plain versions of the kernels). It runs the deployment step,
``PiZero.infer_action`` (``infer_action_naive`` where the config turns the
prefix cache off), with the config's quantization tiers, over the LAST
--examples examples of a dataset, in fixed batches of --batch-size: the last
batch is padded by repeating its final example, and the padded rows are left
out of the metrics.

Data: a sharded dataset directory (``blurr_tpu_torch.data``; raw robot-log
keys go through ``transform_for_config``, the trainer's preprocessing), a
preprocessed ``.npz``, or ``synthetic``. Checkpoints: a reference ``.pt``, a
``train_pi0_flow_torch.py --save-dir`` tree, or ``random``.

Metrics, in the normalized action space, accumulated in fp64 on the host:
mse / mae over the whole chunk, mse over the first --act-steps rows (the
executed prefix), per-dim mse, eef_l2 (the mean L2 error of the first 6
dims per step) and gripper_agreement (the sign-match rate of the last dim).
The flow noise of batch i is JAX's ``normal(fold_in(PRNGKey(seed), i))``
(``ops/prng.py``), so reruns give the same numbers.

--dp N > 1 scores each batch over N data ranks (JAX's 'data' mesh axis),
one process each: this process is rank 0 and spawns the others
(``blurr_tpu_torch/parallel/mesh.py``; gloo on the CPU or where ranks
share a card, nccl where each has its own). Every rank builds the same
model, draws the batch's whole noise and scores its batch-size / N rows;
the error sums are reduced onto rank 0, which alone prints and writes. The
per-example math is unchanged, so the metrics are --dp 1's (up to the
rounding of a matmul at another row count). --batch-size must divide by N.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from blurr_tpu_torch.utils.decorator import main_rank_only  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Open-loop action error of a Pi-0 checkpoint on a recorded dataset's "
                    "validation window (PyTorch port).")
    p.add_argument("--config", type=str, required=True,
                   help="Pi0 config yaml (eval presets select quantization).")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="torch .pt, a train_pi0_flow_torch.py --save-dir tree, or 'random'.")
    p.add_argument("--data", type=str, default="synthetic",
                   help="Sharded dataset dir, .npz with preprocessed keys, or 'synthetic'.")
    p.add_argument("--examples", type=int, default=64,
                   help="Evaluation window size: the LAST N dataset examples.")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--act-steps", type=int, default=4,
                   help="Executed-prefix length for the truncated metrics.")
    p.add_argument("--use-bf16", action="store_true")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel shards over the 'data' ranks "
                        "(needs batch-size divisible by dp; one process per "
                        "rank; per-example math is unchanged, so metrics "
                        "match single-device).")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-json", type=str, default="",
                   help="Also write the metrics dict to this path.")
    p.add_argument("--per-dim", action="store_true", help="Print the per-dim MSE table.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def _synthetic_examples(cfg, n, seed):
    """The schema of train_pi0_flow's synthetic batch, one big batch."""
    rng = np.random.RandomState(seed)
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    seq = cfg["max_image_text_tokens"]
    img = cfg["vision"]["config"]["image_size"]
    ids = np.zeros((n, seq), np.int32)
    am = np.zeros((n, seq), np.int32)
    ids[:, :n_img] = cfg["image_token_index"]
    ids[:, n_img:n_img + 6] = rng.randint(3, 1000, (n, 6))
    am[:, :n_img + 6] = 1
    return {
        "input_ids": ids,
        "attention_mask": am,
        "pixel_values": rng.rand(n, 3, img, img).astype(np.float32) * 2 - 1,
        "proprios": rng.randn(n, cfg["cond_steps"], cfg["proprio_dim"]).astype(np.float32),
        "actions": np.clip(rng.randn(n, cfg["horizon_steps"], cfg["action_dim"]), -1, 1
                           ).astype(np.float32),
    }


REQUIRED_KEYS = ("input_ids", "attention_mask", "pixel_values", "proprios", "actions")


def load_eval_batches(cfg, args):
    """Yield (batch of --batch-size preprocessed rows, number of live rows):
    the last batch is padded by repeating its final example."""
    bs = args.batch_size
    if args.data == "synthetic":
        data = _synthetic_examples(cfg, args.examples, args.seed + 7)
        n = args.examples
    elif args.data.endswith(".npz"):
        data = dict(np.load(args.data))
        missing = [k for k in REQUIRED_KEYS if k not in data]
        if missing:  # before any indexing, so the exit message wins
            sys.exit(f"dataset is missing keys {missing}; has {sorted(data)}")
        n = min(args.examples, data["actions"].shape[0])
        data = {k: v[-n:] for k, v in data.items()}
    else:
        from blurr_tpu_torch.data import ShardedDataset, transform_for_config

        ds = ShardedDataset(args.data)
        n = min(args.examples, ds.num_examples)
        data = ds.gather_batch(np.arange(ds.num_examples - n, ds.num_examples))
        if "actions" not in data:  # raw robot-log keys -> the trainer's preprocessing
            data = transform_for_config(cfg, dataset_statistics=ds.statistics)(data)
    missing = [k for k in REQUIRED_KEYS if k not in data]
    if missing:
        sys.exit(f"dataset is missing keys {missing}; has {sorted(data)}")

    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        live = hi - lo
        batch = {k: v[lo:hi] for k, v in data.items()}
        if live < bs:
            batch = {k: np.concatenate([v] + [v[-1:]] * (bs - live), axis=0)
                     for k, v in batch.items()}
        yield batch, live


def main(argv=None, rank_launches: Optional[list] = None) -> dict:
    """Run the evaluation of ``argv``; with --dp > 1, ``rank_launches`` (a
    list) gets each spawned data rank's kernel launch counts ({name:
    count}), in rank order."""
    args = parse_args(argv)
    if args.dp > 1 and args.batch_size % args.dp:
        sys.exit(f"--batch-size {args.batch_size} must be divisible by --dp {args.dp}")
    if args.dp == 1:
        return evaluate(args)
    from blurr_tpu_torch.parallel.mesh import PG_TIMEOUT_S, Workers, free_tcp_init_method

    init_method = free_tcp_init_method()
    workers = Workers(args.dp, _rank_main, (args, init_method))
    try:
        metrics = _rank_eval(0, args, init_method)
        replies = workers.replies(PG_TIMEOUT_S)
        if rank_launches is not None:
            rank_launches.extend(reply[1] for reply in replies)
    except Exception as exc:
        errs = workers.pending_errors()
        if errs:
            raise RuntimeError("; ".join(errs)) from exc
        raise
    finally:
        workers.join(PG_TIMEOUT_S)
    return metrics


def _rank_main(rank: int, conn, args, init_method: str) -> None:
    """A spawned data rank: score its rows, then report to rank 0 with its
    kernels' launch counts."""
    from blurr_tpu_torch.serving.server import SERVED_KERNELS

    try:
        _rank_eval(rank, args, init_method)
    except BaseException as exc:
        conn.send(("error", f"{type(exc).__name__}: {exc}"))
        raise
    conn.send(("ok", {name: fn.launches for name, fn in SERVED_KERNELS.items()}))


def _rank_eval(rank: int, args, init_method: str):
    import torch.distributed as dist

    from blurr_tpu_torch.parallel.mesh import init_ranks, make_mesh

    backend, device = init_ranks(rank, args.dp, init_method, args.device)
    try:
        return evaluate(args, make_mesh(data=args.dp), device)
    finally:
        dist.destroy_process_group()


def evaluate(args, mesh=None, device=None):
    """The metrics of ``args``' run: on one rank, or this data rank's rows
    of every batch with the sums reduced onto rank 0 (which alone reports
    and returns them; the others return None)."""
    import torch

    from blurr_tpu_torch import benchmarks as B
    from blurr_tpu_torch.ops import prng
    from blurr_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, data_rows

    mesh = mesh or Mesh()
    device = torch.device(device or args.device)
    dtype = torch.bfloat16 if args.use_bf16 else torch.float32
    cfg = B.load_cfg(args.config)
    model = B.load_model(cfg, args.checkpoint, dtype, device)
    infer = (model.infer_action if cfg.get("use_prefix_kv_cache", True)
             else model.infer_action_naive)
    n_tok, act_dim = cfg["horizon_steps"], cfg["action_dim"]
    key = prng.prng_key(args.seed)

    se = np.zeros(act_dim)  # squared error per dim, all steps
    ae = 0.0
    se_prefix = 0.0
    eef_l2_sum = 0.0
    grip_match = 0
    grip_total = 0
    count_steps = 0  # live rows * horizon
    count_prefix = 0
    k = min(args.act_steps, n_tok)
    n_eval = 0
    rows = args.batch_size // mesh.data
    for bidx, (batch, live) in enumerate(load_eval_batches(cfg, args)):
        ids, am = (torch.from_numpy(np.asarray(batch[name], np.int32)).to(device)
                   for name in ("input_ids", "attention_mask"))
        px, pr = (torch.from_numpy(np.asarray(batch[name], np.float32)).to(device, dtype)
                  for name in ("pixel_values", "proprios"))
        noise = prng.normal(prng.fold_in(key, bidx), (ids.shape[0], n_tok, act_dim), dtype,
                            device)
        # this data rank's rows of the batch, and how many of them are live
        live = min(max(live - mesh.data_rank * rows, 0), rows)
        ids, am, px, pr, noise = (data_rows(t, mesh) for t in (ids, am, px, pr, noise))
        pred = infer(ids, am, px, pr, noise).float().cpu().numpy().astype(np.float64)[:live]
        gt = data_rows(torch.from_numpy(np.asarray(batch["actions"], np.float64)),
                       mesh).numpy()[:live]
        err = pred - gt
        se += (err ** 2).sum(axis=(0, 1))
        ae += np.abs(err).sum()
        se_prefix += (err[:, :k] ** 2).sum()
        eef_l2_sum += np.linalg.norm(err[..., :6], axis=-1).sum()
        grip_match += int((np.sign(pred[..., -1]) == np.sign(gt[..., -1])).sum())
        grip_total += live * n_tok
        count_steps += live * n_tok
        count_prefix += live * k
        n_eval += live
    if mesh.data > 1:  # every data rank's sums onto rank 0 (fp64, on the host)
        sums = torch.from_numpy(np.concatenate([se, [ae, se_prefix, eef_l2_sum, grip_match,
                                                     grip_total, count_steps, count_prefix,
                                                     n_eval]]))
        sums = all_reduce_sum(sums, mesh.data_group).numpy()
        if mesh.rank:
            return None
        se, (ae, se_prefix, eef_l2_sum) = sums[:act_dim], sums[act_dim:act_dim + 3]
        grip_match, grip_total, count_steps, count_prefix, n_eval = (
            int(v) for v in sums[act_dim + 3:])
    return _report(args, se, ae, se_prefix, eef_l2_sum, grip_match, grip_total, count_steps,
                   count_prefix, n_eval, n_tok, act_dim, k)


@main_rank_only
def _report(args, se, ae, se_prefix, eef_l2_sum, grip_match, grip_total, count_steps,
            count_prefix, n_eval, n_tok, act_dim, k) -> dict:
    per_dim_mse = se / count_steps
    metrics = {
        "examples": n_eval,
        "horizon": n_tok,
        "act_steps": k,
        "mse": float(per_dim_mse.mean()),
        "mae": float(ae / (count_steps * act_dim)),
        "mse_prefix": float(se_prefix / (count_prefix * act_dim)),
        "eef_l2": float(eef_l2_sum / count_steps),
        "gripper_agreement": float(grip_match / grip_total),
        "per_dim_mse": [float(x) for x in per_dim_mse],
        "config": args.config,
        "checkpoint": args.checkpoint,
        "seed": args.seed,
    }

    print(f"Open-loop eval: {n_eval} examples, horizon {n_tok} (prefix {k})")
    print(f"  action MSE:          {metrics['mse']:.6f}")
    print(f"  action MAE:          {metrics['mae']:.6f}")
    print(f"  prefix MSE:          {metrics['mse_prefix']:.6f}")
    print(f"  EEF L2 / step:       {metrics['eef_l2']:.6f}")
    print(f"  gripper agreement:   {metrics['gripper_agreement']:.4f}")
    if args.per_dim:
        for d, v in enumerate(per_dim_mse):
            print(f"    dim {d}: mse {v:.6f}")
    print(json.dumps(metrics), flush=True)
    if args.output_json:
        Path(args.output_json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.output_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
