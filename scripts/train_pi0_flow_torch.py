#!/usr/bin/env python3
"""Flow-matching fine-tuning of Pi-0 with the PyTorch port (blurr_tpu_torch).

    python scripts/train_pi0_flow_torch.py --config config/eval/bridge.yaml \\
        --lora-rank 16 --lora-quantize-base w4a8 --dtype bf16 \\
        --data DIR --steps 1000 --save-dir runs/ft

The port's counterpart of scripts/train_pi0_flow.py, with its single-card
flags and log lines. It trains on the card (--device, default cuda);
--device cpu runs the plain versions of the kernels. Full fine-tuning of a
--train-scope (all, action_expert, vlm), LoRA (--lora-rank: rank-r adapters
in the --lora-targets projections of the scope; only they train) and QLoRA
(--lora-quantize-base w8a8 / w4a8: the scope's joint mixtures are quantized
first, and their products run torch._int_mm / the int4 kernel with
straight-through gradients). Weights: --checkpoint random (drawn from
--seed), a reference .pt or a --save-dir directory; --pretrained-paligemma
DIR loads PaliGemma's safetensors into the VLM parts. Data: a sharded
dataset directory (blurr_tpu_torch.data; raw keys go through
Pi0TrainTransform), an .npz of model-ready arrays, or 'synthetic'. The
optimizer is optax's adamw over the trainable parameters, stepped by the
warmup-cosine schedule (blurr_tpu_torch/utils/optim.py); the noise and
flow time of each step are drawn from a torch.Generator seeded with
--seed + 1 (JAX draws them from its step key).

--save-dir writes the parameter tree (LoRA merged into plain weights on an
fp base; a QLoRA tree unmerged, with its adapters), which
scripts/serve_pi0_torch.py --checkpoint DIR serves and
scripts/export_torch_checkpoint_torch.py turns into a reference .pt;
--save-state / --save-every / --resume-state save and resume the whole
training state (directories of safetensors and JSON, not orbax).

Parallel training (blurr_tpu_torch/parallel): --dp N splits each batch
over N data ranks (the gradients averaged), --tp M splits the weights over
M model ranks (the tensor-parallel layers), --fsdp shards every weight and
moment over the data ranks too (needs --dp > 1), --sp K splits the SigLIP
patches and the vlm tokens over K sequence ranks (composes with --dp,
--tp and --fsdp), --pp S splits the joint layers over S pipeline stages
(GPipe, --pp-microbatches of the batch; composes with --dp only). Rank 0
spawns the other ranks (one process each, torch.distributed; on one card
they share it over gloo); with --multihost this process instead joins the
process group of a launcher (torchrun and the like: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), whose world must be dp x tp x sp
(dp x pp under --pp). Every rank draws the same global batch, noise and
flow time and takes its rows, so a parallel run follows the run on one
card. Logs and --metrics-csv come from rank 0; the saves hold the gathered
one-card tree, which serves on one card and resumes on any mesh.
"""

from __future__ import annotations

import argparse
import copy
import csv
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

log = logging.getLogger("train_pi0_flow")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default="config/eval/bridge_tiny.yaml")
    p.add_argument("--checkpoint", type=str, default="random",
                   help="'random', a reference .pt, or a --save-dir directory")
    p.add_argument("--pretrained-paligemma", type=str, default="",
                   help="PaliGemma safetensors dir to initialize the VLM parts")
    p.add_argument("--data", type=str, default="synthetic",
                   help="sharded-dataset dir, .npz path, or 'synthetic'")
    p.add_argument("--data-prefetch", type=int, default=2,
                   help="background batches prepared ahead (sharded data; 0 = sync)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train-scope", type=str, default="all",
                   choices=["all", "action_expert", "vlm"])
    p.add_argument("--lora-rank", type=int, default=0)
    p.add_argument("--lora-alpha", type=float, default=0.0,
                   help="s = alpha/rank (0: alpha = rank, s = 1)")
    p.add_argument("--lora-targets", type=str, default="q_w,v_w")
    p.add_argument("--lora-quantize-base", type=str, default="none",
                   choices=["none", "w8a8", "w4a8"])
    p.add_argument("--dtype", type=str, default="fp32",
                   choices=["fp32", "bf16", "master-fp32"])
    p.add_argument("--remat", action="store_true",
                   help="recompute each SigLIP and joint layer in the backward")
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--val-examples", type=int, default=0)
    p.add_argument("--val-every", type=int, default=0)
    p.add_argument("--grad-clip", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--metrics-csv", type=str, default="")
    p.add_argument("--save-dir", type=str, default="")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--save-state", type=str, default="")
    p.add_argument("--resume-state", type=str, default="")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--keep-checkpoints", type=int, default=3)
    p.add_argument("--stop-after", type=int, default=0)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: each takes batch-size / dp rows")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: attention heads, MLP columns, the "
                        "vocabulary and w4a8 blocks split over them")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks: SigLIP patch tokens and the vlm tokens "
                        "split over them, each rank's attention reading every rank's K/V; "
                        "composes with --dp/--tp/--fsdp, not with --pp")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages: the joint layers split over them, the "
                        "batch going through in microbatches (GPipe); composes with --dp "
                        "only")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="microbatch count for --pp (default: the largest valid divisor of "
                        "the batch <= stages, or more while each keeps 8 rows)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard every weight and AdamW moment over the data ranks "
                        "too (ZeRO-3); needs --dp > 1")
    p.add_argument("--multihost", action="store_true",
                   help="join a launcher's process group (env://) instead of "
                        "spawning the ranks")
    return p.parse_args(argv)


def synthetic_batch(cfg, bsz, rng):
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    seq = cfg["max_image_text_tokens"]
    img = cfg["vision"]["config"]["image_size"]
    ids = np.zeros((bsz, seq), np.int32)
    am = np.zeros((bsz, seq), np.int32)
    ids[:, :n_img] = cfg["image_token_index"]
    ids[:, n_img : n_img + 6] = rng.randint(3, 1000, (bsz, 6))
    am[:, : n_img + 6] = 1
    return {
        "input_ids": ids,
        "attention_mask": am,
        "pixel_values": rng.rand(bsz, 3, img, img).astype(np.float32) * 2 - 1,
        "proprios": rng.randn(bsz, cfg["cond_steps"], cfg["proprio_dim"]).astype(
            np.float32
        ),
        "actions": np.clip(
            rng.randn(bsz, cfg["horizon_steps"], cfg["action_dim"]), -1, 1
        ).astype(np.float32),
    }


def _check_parallel(args) -> None:
    """JAX's checks of the parallel flags, with its messages."""
    if args.fsdp and args.dp <= 1:
        sys.exit("--fsdp shards over the 'data' axis; it needs --dp > 1")
    if args.pp > 1 and (args.tp > 1 or args.sp > 1 or args.fsdp):
        sys.exit("--pp composes with --dp only; drop --tp/--sp/--fsdp")
    if min(args.dp, args.tp, args.sp, args.pp) < 1:
        sys.exit(f"--dp {args.dp} --tp {args.tp} --sp {args.sp} --pp {args.pp}: each needs "
                 "at least one rank")
    if args.batch_size % args.dp:
        sys.exit(f"--batch-size {args.batch_size} must be divisible by --dp {args.dp}")
    if args.pp > 1:  # JAX's pipeline checks, before any rank starts
        from blurr_tpu_torch.parallel.pipeline import UNEVEN_STAGES, microbatch_count
        from blurr_tpu_torch.presets import load_config

        try:
            microbatch_count(args.batch_size, args.pp, args.dp, args.pp_microbatches or None)
        except ValueError as exc:
            sys.exit(str(exc))
        n = load_config(args.config)["joint"]["config"]["num_hidden_layers"]
        if n % args.pp:
            sys.exit(UNEVEN_STAGES.format(path="joint.vlm.layers", n=n, stages=args.pp))


def _to_device(batch, device):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _inject_lora(model, args, device) -> None:
    """Adapters in the --train-scope group only; QLoRA quantizes that
    group's joint mixtures first (SigLIP and the projector stay fp)."""
    import torch

    from blurr_tpu_torch.ops.lora import inject_lora_tree
    from blurr_tpu_torch.ops.quant import quantize_mixture_w4a8, quantize_mixture_w8a8

    targets = tuple(t.strip() for t in args.lora_targets.split(",") if t.strip())
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    alpha = args.lora_alpha or None
    quantize = {"none": None, "w8a8": quantize_mixture_w8a8,
                "w4a8": quantize_mixture_w4a8}[args.lora_quantize_base]

    def inject(mod, mixture=False):
        if mixture and quantize is not None:
            quantize(mod.layers)
        inject_lora_tree(mod, gen, args.lora_rank, targets, alpha)

    scope = args.train_scope
    if scope in ("all", "vlm"):
        inject(model.vision_tower)
    if scope == "all":
        inject(model.multi_modal_projector)
    if scope in ("all", "vlm"):
        inject(model.joint["vlm"], mixture=True)
    if scope in ("all", "action_expert"):
        inject(model.joint["action"], mixture=True)


def main(argv=None):
    """Train as the flags say, on every rank. Returns rank 0's namespace of
    the model, the optimizer, the EMA and the per-step losses (device
    tensors), its ``ranks`` every rank's summary
    (``parallel/train.py:rank_summary``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    _check_parallel(args)
    from blurr_tpu_torch.parallel.train import run_ranks

    return run_ranks(train, argv, args.dp, args.tp, args.multihost, args.device, sp=args.sp,
                     pp=args.pp)


def train(argv, rank: int = 0, world: int = 1, init_method=None):
    """One rank's run (``main``'s, on rank ``rank`` of ``world``: the
    process group joined at ``init_method``, or already joined)."""
    args = parse_args(argv)
    if rank:
        logging.basicConfig(level=logging.WARNING)
        logging.getLogger().setLevel(logging.WARNING)
    import torch

    from blurr_tpu_torch.models.pi0.checkpoint import (
        TrainCheckpointManager,
        is_manager_root,
        load_checkpoint,
        restore_params,
        restore_train_state,
        save_params,
        save_train_state,
    )
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.models.pi0.trainable import SCOPES, apply_mask
    from blurr_tpu_torch.ops.lora import lora_trainable_mask, merge_lora_tree
    from blurr_tpu_torch.parallel.train import (
        join_mesh,
        make_train_step,
        record_token_rows,
        sample_noise_and_t,
    )
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.utils.decorator import main_rank_only
    from blurr_tpu_torch.utils.optim import (
        AdamW,
        ParamsEMA,
        cast_floating_preserving_scales,
        cast_params,
        cosine_annealing_warmup_restarts,
        extract_ema,
        warmup_cosine_decay_schedule,
    )

    device, mesh = join_mesh(rank, world, init_method, args.device, args.dp, args.tp, args.sp,
                             args.pp)
    cfg = load_config(args.config)
    model = PiZero(cfg, device=device, dtype=torch.float32)
    if str(args.checkpoint).lower() in {"random", "none", ""}:
        model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    else:
        load_checkpoint(model, args.checkpoint)
    if args.pretrained_paligemma:
        model.load_pretrained_weights(args.pretrained_paligemma)
    if args.resume:
        restore_params(model, args.resume)
        log.info("Resumed from %s", args.resume)
    if args.lora_rank > 0:
        _inject_lora(model, args, device)

    compute_dtype = None
    if args.dtype == "bf16":
        cast_floating_preserving_scales(model, torch.bfloat16)
    elif args.dtype == "master-fp32":
        compute_dtype = torch.bfloat16

    pipeline = None
    if mesh is not None:
        # JAX shards after the adapters and the cast, and inits the
        # optimizer after sharding: the moments take the shards' shapes
        from blurr_tpu_torch.parallel.fsdp import shard_fsdp, split_axes
        from blurr_tpu_torch.parallel.mesh import shard_params
        from blurr_tpu_torch.parallel.pipeline import (
            PipelineCtx,
            microbatch_count,
            shard_params_pipeline,
        )

        if args.pp > 1:
            shard_params_pipeline(model, mesh)
            pipeline = PipelineCtx(mesh, microbatches=args.pp_microbatches or None)
            n_micro = microbatch_count(args.batch_size, args.pp, args.dp, pipeline.microbatches)
        else:
            shard_params(model, mesh)
            if args.fsdp:
                shard_fsdp(model, mesh)
    mask = (lora_trainable_mask(model) if args.lora_rank > 0
            else SCOPES[args.train_scope](model))
    trainable = apply_mask(model, mask)
    split = None if mesh is None else split_axes(model, trainable, mesh)
    if pipeline is not None:
        log.info("Mesh: dp %d x pp %d, %d microbatches of %d rows, rank 0 on %s", args.dp,
                 args.pp, n_micro, args.batch_size // n_micro, device)
    elif mesh is not None:
        log.info("Mesh: dp %d x sp %d x tp %d%s, rank 0 on %s", args.dp, args.sp, args.tp,
                 " (FSDP over the data ranks)" if args.fsdp else "", device)
    rows = record_token_rows(model) if args.sp > 1 else {}
    n_train = sum(p.numel() for p in trainable)
    log.info("Trainable parameters: %s (%s)", f"{n_train:,}",
             f"LoRA rank {args.lora_rank}" if args.lora_rank > 0 else args.train_scope)

    # the optimizer steps optax's warmup-cosine schedule once per UPDATE
    # (every k-th micro-batch under --accum-steps); the log reads the host
    # schedule at the same update count
    k = max(args.accum_steps, 1)
    total_updates = max(-(-args.steps // k), 2)
    warmup = min(-(-args.warmup_steps // k), max(total_updates - 1, 1))
    schedule = warmup_cosine_decay_schedule(
        init_value=args.lr * 0.01, peak_value=args.lr, warmup_steps=warmup,
        decay_steps=total_updates, end_value=args.lr * 0.01)
    log_schedule = cosine_annealing_warmup_restarts(
        first_cycle_steps=total_updates, max_lr=args.lr, min_lr=args.lr * 0.01,
        warmup_steps=warmup)
    optimizer = AdamW(trainable, schedule, grad_clip=args.grad_clip, mesh=mesh, split=split)
    ema = ParamsEMA(trainable, args.ema_decay) if args.ema_decay > 0 else None
    train_step = make_train_step(model, optimizer, remat=args.remat,
                                 compute_dtype=compute_dtype, accum_steps=k, ema=ema,
                                 mesh=mesh, pipeline=pipeline)
    accumulator = train_step.accumulator

    from blurr_tpu_torch.data import is_sharded_dataset

    nrng = np.random.RandomState(args.seed)
    data = loader = ds = transform = None
    train_hi = 0
    if is_sharded_dataset(args.data):
        from blurr_tpu_torch.data import ShardedBatchLoader, ShardedDataset, transform_for_config

        ds = ShardedDataset(args.data)
        if any(key in ds.keys for key in ("image", "proprio", "action")):
            transform = transform_for_config(cfg, dataset_statistics=ds.statistics)
        train_hi = ds.num_examples
        if args.val_examples > 0:
            if ds.num_examples - args.val_examples < args.batch_size:
                sys.exit(f"--val-examples {args.val_examples} leaves fewer than "
                         f"one training batch of {args.batch_size}")
            train_hi = ds.num_examples - args.val_examples
        loader = ShardedBatchLoader(ds, args.batch_size, seed=args.seed, transform=transform,
                                    prefetch=max(args.data_prefetch, 0),
                                    example_range=(0, train_hi))
        log.info("Sharded dataset %s: %d examples (%d train / %d val), %d batches/epoch%s",
                 args.data, ds.num_examples, train_hi, ds.num_examples - train_hi,
                 loader.batches_per_epoch,
                 " (raw keys -> Pi0TrainTransform)" if transform else "")
    elif args.data != "synthetic":
        data = dict(np.load(args.data))
        log.info("Loaded %d examples from %s", data["actions"].shape[0], args.data)

    def next_batch():
        if loader is not None:
            return loader.next_batch()
        if data is None:
            return synthetic_batch(cfg, args.batch_size, nrng)
        idx = nrng.randint(0, data["actions"].shape[0], args.batch_size)
        return {key: v[idx] for key, v in data.items()}

    ckpt_mgr = None
    if args.save_every > 0:
        if not args.save_state:
            sys.exit("--save-every needs --save-state <manager root>")
        ckpt_mgr = TrainCheckpointManager(args.save_state, keep=args.keep_checkpoints,
                                          mesh=mesh)

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    start_step = 0
    if args.resume_state:
        parts = (model, optimizer, accumulator, ema)
        if is_manager_root(args.resume_state):
            same_root = ckpt_mgr is not None and os.path.abspath(
                args.resume_state) == os.path.abspath(args.save_state)
            rmgr = ckpt_mgr if same_root else TrainCheckpointManager(
                args.resume_state, keep=args.keep_checkpoints, mesh=mesh)
            start_step, rng_state = rmgr.restore(*parts)
            if rmgr is not ckpt_mgr:
                rmgr.close()
        else:
            start_step, rng_state = restore_train_state(args.resume_state, *parts, mesh=mesh)
        gen.set_state(rng_state)
        if loader is not None:
            loader.restore(start_step)
        else:
            for _ in range(start_step):
                next_batch()
        log.info("Resumed training state from %s at step %d", args.resume_state, start_step)

    if args.val_examples > 0 and loader is None:
        sys.exit("--val-examples needs a sharded dataset (--data <dir>)")
    run_validation = None
    if args.val_examples > 0:
        from blurr_tpu_torch.data import ShardedBatchLoader

        val_bs = min(args.batch_size, args.val_examples)
        val_loader = ShardedBatchLoader(ds, val_bs, seed=args.seed, shuffle=False,
                                        transform=transform,
                                        example_range=(train_hi, ds.num_examples))
        val_batches = [val_loader.next_batch() for _ in range(val_loader.batches_per_epoch)]
        # fixed (t, x0) per batch, JAX's draws: the metric stays comparable
        vrng = np.random.RandomState(args.seed + 999)
        val_fixed = [
            (torch.from_numpy(vrng.beta(1.5, 1.0, b["actions"].shape[0]).astype(np.float32)),
             torch.from_numpy(vrng.randn(*b["actions"].shape).astype(np.float32)))
            for b in val_batches
        ]

        @torch.no_grad()
        def run_validation():
            from blurr_tpu_torch.parallel.mesh import all_reduce_sum, data_rows

            vdt = compute_dtype or next(
                p.dtype for p in model.parameters() if p.is_floating_point())
            params = cast_params(model, compute_dtype) if compute_dtype else None
            tot = 0.0
            for b, (t_f, x0_f) in zip(val_batches, val_fixed):
                tb = _to_device(b, device)
                tb = {key: v.to(vdt) if v.is_floating_point() else v for key, v in tb.items()}
                args_ = (tb["input_ids"], tb["attention_mask"], tb["pixel_values"],
                         tb["proprios"], tb["actions"], t_f.to(device), x0_f.to(device))
                # over the data ranks: each scores its rows of a batch that splits
                split_rows = mesh is not None and args_[0].shape[0] % mesh.data == 0
                if split_rows:
                    args_ = tuple(data_rows(a, mesh) for a in args_)
                kw = {"pipeline": pipeline} if pipeline is not None else {}
                if args.sp > 1:
                    kw["sp"] = mesh
                loss_v = (model.flow_loss(*args_, **kw) if params is None
                          else torch.func.functional_call(model, params, args_, kw))
                if split_rows and mesh.data > 1:
                    loss_v = all_reduce_sum(loss_v.float().reshape(1), mesh.data_group) / mesh.data
                tot += float(loss_v)
            return tot / len(val_batches)

        log.info("Validation split: %d examples (%d batches of %d)",
                 args.val_examples, len(val_batches), val_bs)

    feed = None
    if loader is not None and args.data_prefetch > 0:
        from blurr_tpu_torch.data import device_prefetch

        feed = device_prefetch(loader, depth=2, device=device)
    from blurr_tpu_torch.parallel.train import kernel_launches

    t0 = time.time()
    loss = torch.full((), float("nan"))
    losses = []
    steps_done = start_step
    before = kernel_launches()
    for step in range(start_step, args.steps):
        batch = next(feed) if feed is not None else _to_device(next_batch(), device)
        noise, t = sample_noise_and_t(gen, batch["actions"])
        loss = train_step(batch, noise, t)
        losses.append(loss)
        steps_done = step + 1
        if ckpt_mgr is not None and steps_done % args.save_every == 0:
            ckpt_mgr.save(steps_done, model, optimizer, gen.get_state(), accumulator, ema)
        val = None
        if run_validation is not None and args.val_every > 0 and steps_done % args.val_every == 0:
            val = run_validation()
            log.info("step %d validation loss %.5f", step, val)
        if args.stop_after and steps_done >= args.stop_after:
            log.info("Stopping after %d steps (--stop-after)", steps_done)
            break
        if step % args.log_every == 0 or step == args.steps - 1:
            elapsed = time.time() - t0
            lr = log_schedule(step // k)
            log.info("step %d/%d loss %.5f lr %.2e elapsed %.1fs",
                     step, args.steps, float(loss), lr, elapsed)
            if args.metrics_csv:
                main_rank_only(_write_metrics)(
                    args.metrics_csv, step, float(loss), lr, elapsed,
                    (step - start_step + 1) * args.batch_size / max(elapsed, 1e-9), val)

    launches = {k: n - before[k] for k, n in kernel_launches().items()}
    if run_validation is not None:
        log.info("Final validation loss %.5f", run_validation())
    if loader is not None:
        loader.close()
    if args.save_dir:
        merge = args.lora_rank > 0 and args.lora_quantize_base == "none"
        if args.lora_rank > 0 and not merge:
            log.info("QLoRA: saving the adapter tree unmerged")

        def save_final(values, path):
            if mesh is not None:
                return _save_sharded(model, mesh, cfg, values, merge, path)
            out = model
            if merge or values is not None:
                out = copy.deepcopy(model)
            if values is not None:
                with torch.no_grad():
                    for name, p in out.named_parameters():
                        p.copy_(values[name])
            if merge:
                merge_lora_tree(out)
            save_params(out, path)

        save_final(None, args.save_dir)
        log.info("Saved params to %s", args.save_dir)
        if ema is not None:
            save_final(extract_ema(ema, model), args.save_dir + "_ema")
            log.info("Saved EMA params to %s_ema", args.save_dir)
    if args.save_state:
        if ckpt_mgr is not None:
            if steps_done > 0 and ckpt_mgr.latest_step() != steps_done:
                ckpt_mgr.save(steps_done, model, optimizer, gen.get_state(), accumulator, ema)
            ckpt_mgr.close()
            log.info("Saved training state to %s (latest step %d)", args.save_state,
                     steps_done)
        else:
            save_train_state(args.save_state, model, optimizer, steps_done, gen.get_state(),
                             accumulator, ema, mesh=mesh)
            log.info("Saved training state to %s", args.save_state)
    log.info("Done. final loss %.5f", float(loss))
    return argparse.Namespace(model=model, optimizer=optimizer, ema=ema, losses=losses,
                              steps_done=steps_done, args=args, rank=rank, mesh=mesh,
                              launches=launches, rows=rows)



def _write_metrics(path, step, loss, lr, elapsed, samples_per_s, val) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    new = not path.exists()
    with path.open("a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["step", "loss", "lr", "wall_s", "samples_per_s", "val_loss"])
        w.writerow([step, f"{loss:.6f}", f"{lr:.3e}", f"{elapsed:.2f}", f"{samples_per_s:.2f}",
                    "" if val is None else f"{val:.6f}"])


def _save_sharded(model, mesh, cfg, values, merge: bool, path: str) -> None:
    """--save-dir over a mesh: the gathered one-card tree (``values``, the
    EMA's, in place of the parameters when given; LoRA merged into an fp
    base with ``merge``, on a one-card model rank 0 rebuilds from it).
    Every rank calls it; rank 0 writes."""
    from blurr_tpu_torch.models.pi0.checkpoint import (
        _after_write,
        _load_tree,
        _sharded_params_snapshot,
        _write_params,
        save_params,
    )
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.lora import merge_lora_tree

    snap = _sharded_params_snapshot(model, mesh, None if values is None else {"v": values})
    if snap is not None:
        tensors, tree, groups = snap
        tensors.update(groups.get("v", {}))
        if merge:
            dtype = next(t.dtype for t in tensors.values() if t.is_floating_point())
            one = PiZero(cfg, device="cpu", dtype=dtype)
            _load_tree(one, tree["modules"], tensors)
            merge_lora_tree(one)
            save_params(one, path)
        else:
            _write_params(path, tensors, tree)
    _after_write(mesh)


if __name__ == "__main__":
    main()
