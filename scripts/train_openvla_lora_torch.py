#!/usr/bin/env python3
"""LoRA / QLoRA fine-tuning of the OpenVLA family with the PyTorch port
(blurr_tpu_torch).

    python scripts/train_openvla_lora_torch.py --model-id random-7b \\
        --quantize-base w4a8 --data DIR --steps 500 --lora-rank 32 \\
        --save-adapter out/lora_adapter --save-params out/params

The port's counterpart of scripts/train_openvla_lora.py, with its flags,
defaults and log lines plus --device. It trains on the card (--device,
default cuda); --device cpu runs the plain versions of the kernels. The
objective is the teacher-forced cross-entropy of the action_dim action
tokens (OpenVLA.action_ce_loss), or with --oft the L1 of OFT's continuous
chunk (OpenVLAOFT.oft_l1_loss; the action head, and the proprio projector
with --use-proprio, train fully beside the adapters). Rank-r adapters go on
the --lora-targets LLM projections, drawn from a torch.Generator seeded
with --seed + 7 (JAX draws them from PRNGKey(seed + 7)); only the factors
train. --quantize-base w8a8 / w4a8 (QLoRA) builds the frozen LLM quantized
(a random id draws it quantized, never in bf16) and its products run
torch._int_mm / the int4 kernel with straight-through gradients. The
optimizer is optax's adamw over the trainable parameters with a global-norm
clip, stepped by the warmup-cosine schedule in optimizer-update units
(--accum-steps), with an optional --ema-decay.

Data: a sharded dataset directory (blurr_tpu_torch/models/openvla/data.py's
keys), an .npz of images [N, H, W, 3] uint8, instructions [N] and actions
[N, action_dim] (OFT: [N, chunk_len, action_dim]; proprios with
--use-proprio), or 'synthetic'.

--save-adapter writes a PEFT lora_adapter/ directory (and <dir>_ema with
--ema-decay; with --oft the head and projector as action_head--N_checkpoint.pt
/ proprio_projector--N_checkpoint.pt beside it); --save-params writes the
whole parameter tree (params.safetensors + tree.json), which
scripts/serve_openvla_torch.py --checkpoint and
scripts/eval_openloop_vla_torch.py --checkpoint read; --save-state /
--save-every / --resume-state save and resume the whole training state
(directories of safetensors and JSON, not orbax).

--dp N, --tp M and --fsdp train over N x M ranks that rank 0 spawns
(blurr_tpu_torch/parallel; scripts/train_pi0_flow_torch.py's docstring):
each rank takes its rows of the same global batch, the LLM's heads, MLP
columns and vocabulary split over the model ranks, and every save holds the
gathered one-card tree. --tp with w4a8 is refused, as JAX refuses it.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

log = logging.getLogger("train_openvla_lora")

AR_KEYS = ("input_ids", "attn_valid", "pixel_values", "labels")
OFT_KEYS = ("input_ids", "attn_valid", "pixel_values", "actions")




def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-id", type=str, default="random",
                   help="HF snapshot dir, or random / random-7b / random-minivla / "
                        "random-minivla-tiny")
    p.add_argument("--data", type=str, default="synthetic",
                   help="sharded-dataset dir, .npz of (images, instructions, actions), "
                        "or 'synthetic'")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lora-rank", type=int, default=32)
    p.add_argument("--lora-alpha", type=float, default=0.0,
                   help="s = alpha/rank (0: alpha = rank)")
    p.add_argument("--lora-targets", type=str, default="q_w,k_w,v_w,o_w,gate_w,up_w,down_w")
    p.add_argument("--quantize-base", type=str, default="none",
                   choices=["none", "w8a8", "w4a8"])
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--max-text-tokens", type=int, default=32)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--remat", action="store_true",
                   help="recompute each LLM layer in the backward")
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--save-adapter", type=str, default="")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: each takes batch-size / dp rows")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (not with --quantize-base w4a8)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the weights and moments over the data ranks; needs --dp > 1")
    p.add_argument("--save-params", type=str, default="")
    p.add_argument("--save-state", type=str, default="")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--keep-checkpoints", type=int, default=3)
    p.add_argument("--resume-state", type=str, default="")
    p.add_argument("--stop-after", type=int, default=0)
    p.add_argument("--oft", action="store_true")
    p.add_argument("--chunk-len", type=int, default=8)
    p.add_argument("--use-proprio", action="store_true")
    p.add_argument("--proprio-dim", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def synthetic_examples(n, image_hw, action_shape, seed, proprio_dim=0):
    """JAX's synthetic set: random frames, four instructions in turn, and
    actions N(0, 0.4) clipped to [-1, 1], from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    phrases = ["pick up the carrot", "put the spoon on the towel",
               "move the cup near the plate", "stack the green block"]
    out = {
        "images": rng.randint(0, 256, (n, image_hw, image_hw, 3), np.uint8),
        "instructions": np.array([phrases[i % len(phrases)] for i in range(n)]),
        "actions": np.clip(rng.randn(n, *action_shape) * 0.4, -1, 1).astype(np.float32),
    }
    if proprio_dim:
        out["proprios"] = rng.randn(n, proprio_dim).astype(np.float32)
    return out


def _check_parallel(args) -> None:
    """JAX's checks of the parallel flags, in JAX's words."""
    if args.fsdp and args.dp <= 1:
        sys.exit("--fsdp shards over the 'data' axis; it needs --dp > 1")
    if args.quantize_base == "w4a8" and args.tp > 1:
        sys.exit("--tp with w4a8: the block-major int4 packing does not "
                 "TP-shard; use w8a8 or tp=1")
    if args.dp < 1 or args.tp < 1:
        sys.exit(f"--dp {args.dp} --tp {args.tp}: each needs at least one rank")
    if args.batch_size % args.dp:
        sys.exit(f"--batch-size {args.batch_size} must be divisible by --dp {args.dp}")


def ce_loss(model, input_ids, attn_valid, pixel_values, labels, remat=False):
    return model.action_ce_loss(input_ids, attn_valid, pixel_values, labels, remat=remat)


def l1_loss(model, input_ids, attn_valid, pixel_values, actions, proprio=None, remat=False):
    return model.oft_l1_loss(input_ids, pixel_values, actions, proprio, attn_valid=attn_valid,
                             remat=remat)


def main(argv=None):
    """Train as the flags say, on every rank. Returns rank 0's namespace of
    the model, the optimizer, the EMA and the per-step losses (device
    tensors), its ``ranks`` every rank's summary."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    _check_parallel(args)
    from blurr_tpu_torch.parallel.train import run_ranks

    return run_ranks(train, argv, args.dp, args.tp, False, args.device)


def train(argv, rank: int = 0, world: int = 1, init_method=None):
    """One rank's run (``main``'s, on rank ``rank`` of ``world``)."""
    args = parse_args(argv)
    if rank:
        logging.basicConfig(level=logging.WARNING)
        logging.getLogger().setLevel(logging.WARNING)
    import torch

    from blurr_tpu_torch.data import is_sharded_dataset
    from blurr_tpu_torch.models.openvla.build import build_openvla
    from blurr_tpu_torch.models.openvla.processing import (
        OpenVLAProcessor,
        process_image,
        tokenize_prompt_ids,
    )
    from blurr_tpu_torch.models.pi0.checkpoint import (
        TrainCheckpointManager,
        is_manager_root,
        restore_train_state,
        save_params,
        save_train_state,
    )
    from blurr_tpu_torch.models.pi0.trainable import apply_mask
    from blurr_tpu_torch.ops.lora import inject_lora_tree, lora_trainable_mask, save_peft_adapter
    from blurr_tpu_torch.parallel.train import join_mesh, make_train_step
    from blurr_tpu_torch.utils.optim import (
        AdamW,
        ParamsEMA,
        extract_ema,
        warmup_cosine_decay_schedule,
    )

    device, mesh = join_mesh(rank, world, init_method, args.device, args.dp, args.tp)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    try:
        built = build_openvla(args.model_id, device=device, dtype=dtype, oft=args.oft,
                              chunk_len=args.chunk_len, use_proprio=args.use_proprio,
                              proprio_dim=args.proprio_dim, quantization=args.quantize_base,
                              memory_safe_quant_init=True, seed=args.seed)
    except ValueError as exc:
        sys.exit(str(exc))
    model, spec = built.model, built.spec

    targets = tuple(t.strip() for t in args.lora_targets.split(",") if t.strip())
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    inject_lora_tree(model.llama, gen, args.lora_rank, targets, args.lora_alpha or None,
                     dtype=dtype)
    if mesh is not None:  # after the adapters, before the optimizer (as JAX)
        from blurr_tpu_torch.parallel.fsdp import shard_fsdp, split_axes
        from blurr_tpu_torch.parallel.mesh import shard_params

        shard_params(model, mesh)
        if args.fsdp:
            shard_fsdp(model, mesh)
    mask = lora_trainable_mask(model)
    if args.oft:
        # the OFT modules train fully beside the factors (upstream OFT's recipe)
        aux = ("action_head.",) + (("proprio_projector.",) if args.use_proprio else ())
        mask = {n: m or n.startswith(aux) for n, m in mask.items()}
    trainable = apply_mask(model, mask)
    split = None if mesh is None else split_axes(model, trainable, mesh)
    if mesh is not None:
        log.info("Mesh: dp %d x tp %d%s, rank 0 on %s", args.dp, args.tp,
                 " (FSDP over the data ranks)" if args.fsdp else "", device)
    n_train = sum(p.numel() for p in trainable)
    n_total = sum(p.numel() for p in model.parameters()) + sum(b.numel() for b in model.buffers())
    log.info("Trainable LoRA parameters: %s of %s (%.3f%%)", f"{n_train:,}", f"{n_total:,}",
             100.0 * n_train / n_total)

    # the schedule counts optimizer updates (every k-th micro-batch)
    k = max(args.accum_steps, 1)
    total = max(-(-args.steps // k), 2)
    schedule = warmup_cosine_decay_schedule(
        init_value=args.lr * 0.01, peak_value=args.lr,
        warmup_steps=min(-(-args.warmup_steps // k), total - 1), decay_steps=total,
        end_value=args.lr * 0.01)
    optimizer = AdamW(trainable, schedule, grad_clip=args.grad_clip, mesh=mesh, split=split)
    ema = ParamsEMA(trainable, args.ema_decay) if args.ema_decay > 0 else None
    if args.oft:
        loss_fn, keys = l1_loss, OFT_KEYS + (("proprio",) if args.use_proprio else ())
    else:
        loss_fn, keys = ce_loss, AR_KEYS
    train_step = make_train_step(model, optimizer, remat=args.remat, accum_steps=k, ema=ema,
                                 loss_fn=loss_fn, batch_keys=keys, mesh=mesh)

    # ------------------------------------------------------------------
    # data
    size, fused = spec.siglip.image_size, spec.use_fused_vision
    processor = OpenVLAProcessor(built.tokenizer, image_size=size, fused=fused)
    want = (args.chunk_len, spec.action_dim) if args.oft else (spec.action_dim,)
    loader = data = None
    if args.data != "synthetic" and is_sharded_dataset(args.data):
        from blurr_tpu_torch.data import ShardedBatchLoader, ShardedDataset
        from blurr_tpu_torch.models.openvla.data import OpenVLATrainTransform

        ds = ShardedDataset(args.data)
        n_examples = ds.num_examples
        a_shape = tuple(ds.keys["action"]["shape"])
        if a_shape != want:
            sys.exit(f"dataset action shape {a_shape} != expected {want} "
                     f"(--oft={args.oft}, --chunk-len={args.chunk_len})")
        if args.use_proprio and "proprio" not in ds.keys:
            sys.exit("--use-proprio needs a 'proprio' key in the dataset")
        loader = ShardedBatchLoader(
            ds, args.batch_size, seed=args.seed, prefetch=2,
            transform=OpenVLATrainTransform(model, size, fused, oft=args.oft,
                                            use_proprio=args.use_proprio))
        log.info("Sharded dataset %s: %d examples, %d batches/epoch", args.data, n_examples,
                 loader.batches_per_epoch)
    elif args.data == "synthetic":
        data = synthetic_examples(64, size, want, args.seed,
                                  proprio_dim=args.proprio_dim if args.use_proprio else 0)
    else:
        data = dict(np.load(args.data, allow_pickle=True))
    if data is not None:
        n_examples = data["actions"].shape[0]
        if args.oft:
            if tuple(data["actions"].shape[1:]) != want:
                sys.exit(f"--oft expects actions [N, {want[0]}, {want[1]}], "
                         f"got {data['actions'].shape}")
            if args.use_proprio and "proprios" not in data:
                sys.exit("--use-proprio needs a 'proprios' key in the data")
        log.info("Dataset: %d examples", n_examples)

    tok_cache = {}

    def prompt_ids(instruction: str):
        ids = tok_cache.get(instruction)
        if ids is None:
            ids = tok_cache[instruction] = tokenize_prompt_ids(
                processor.tokenizer, instruction, args.max_text_tokens)
        return ids

    rng = np.random.RandomState(args.seed)

    def draw_indices():
        return rng.randint(0, n_examples, args.batch_size)

    def next_host_batch():
        """The next batch as numpy arrays (JAX's assembly)."""
        if loader is not None:
            return loader.next_batch()
        idx = draw_indices()
        px = np.concatenate([process_image(np.asarray(data["images"][i]), size, fused)
                             for i in idx], 0)
        prompts = [prompt_ids(str(data["instructions"][i])) for i in idx]
        if args.oft:
            # ragged prompts right-pad to max_text_tokens; attn_valid gives
            # each row its unpadded forward
            ids = np.zeros((args.batch_size, args.max_text_tokens), np.int32)
            valid = np.zeros_like(ids)
            for row, p_ids in enumerate(prompts):
                ids[row, :len(p_ids)] = p_ids
                valid[row, :len(p_ids)] = 1
            out = {"input_ids": ids, "attn_valid": valid, "pixel_values": px,
                   "actions": np.stack([data["actions"][i] for i in idx]).astype(np.float32)}
            if args.use_proprio:
                out["proprio"] = np.stack([data["proprios"][i] for i in idx]).astype(np.float32)
            return out
        seq = args.max_text_tokens + spec.action_dim
        ids = np.zeros((args.batch_size, seq), np.int32)
        valid = np.zeros_like(ids)
        labels = action_tokens_all[idx]
        for row, p_ids in enumerate(prompts):
            n = len(p_ids)
            ids[row, :n] = p_ids
            ids[row, n:n + spec.action_dim] = labels[row]
            valid[row, :n + spec.action_dim] = 1
        return {"input_ids": ids, "attn_valid": valid, "pixel_values": px, "labels": labels}

    if data is not None and not args.oft:
        action_tokens_all = model.tokenize_actions(data["actions"])

    def next_batch():
        return {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for key, v in next_host_batch().items()}

    ckpt_mgr = None
    if args.save_every > 0:
        if not args.save_state:
            sys.exit("--save-every needs --save-state <manager root>")
        ckpt_mgr = TrainCheckpointManager(args.save_state, keep=args.keep_checkpoints,
                                          mesh=mesh)

    # the step draws nothing: the generator state saved with a training
    # state is a placeholder (the data stream is a function of --seed)
    rng_state = torch.Generator().manual_seed(args.seed).get_state()
    parts = (model, optimizer, train_step.accumulator, ema)
    start_step = 0
    if args.resume_state:
        if is_manager_root(args.resume_state):
            same_root = ckpt_mgr is not None and os.path.abspath(
                args.resume_state) == os.path.abspath(args.save_state)
            rmgr = ckpt_mgr if same_root else TrainCheckpointManager(
                args.resume_state, keep=args.keep_checkpoints, mesh=mesh)
            start_step, _ = rmgr.restore(*parts)
            if rmgr is not ckpt_mgr:
                rmgr.close()
        else:
            start_step, _ = restore_train_state(args.resume_state, *parts, mesh=mesh)
        if loader is not None:
            loader.restore(start_step)
        else:
            for _ in range(start_step):  # index draws only, no pixels
                draw_indices()
        log.info("Resumed training state from %s at step %d", args.resume_state, start_step)

    from blurr_tpu_torch.parallel.train import kernel_launches

    t0 = time.time()
    loss = torch.full((), float("nan"))
    losses = []
    steps_done = start_step
    before = kernel_launches()
    for it in range(start_step, args.steps):
        loss = train_step(next_batch())
        losses.append(loss)
        steps_done = it + 1
        if ckpt_mgr is not None and steps_done % args.save_every == 0:
            ckpt_mgr.save(steps_done, model, optimizer, rng_state, *parts[2:])
        if args.stop_after and steps_done >= args.stop_after:
            log.info("Stopping after %d steps (--stop-after)", steps_done)
            break
        if it % args.log_every == 0 or it == args.steps - 1:
            log.info("step %d/%d loss %.5f elapsed %.1fs", it, args.steps, float(loss),
                     time.time() - t0)

    launches = {key: n - before[key] for key, n in kernel_launches().items()}
    if args.save_adapter and mesh is not None:
        _save_adapter_sharded(model, mesh, ema, args)
    elif args.save_adapter:
        n = save_peft_adapter(model.llama, args.save_adapter, base_model_name=str(args.model_id))
        log.info("Exported %d LoRA factor pairs to %s (PEFT format)", n, args.save_adapter)
        if ema is not None:
            values = extract_ema(ema, model)
            llama = copy.deepcopy(model.llama)
            with torch.no_grad():
                for name, p in llama.named_parameters():
                    p.copy_(values["llama." + name])
            save_peft_adapter(llama, args.save_adapter + "_ema", base_model_name=str(args.model_id))
            del llama
            log.info("Exported EMA factors to %s_ema", args.save_adapter)
        if args.oft:
            from blurr_tpu_torch.models.openvla.checkpoint import save_oft_aux_params

            aux_dir = str(Path(args.save_adapter).parent)
            save_oft_aux_params(aux_dir, model.action_head,
                                model.proprio_projector if args.use_proprio else None,
                                step=args.steps)
            log.info("Exported OFT aux checkpoints to %s", aux_dir)
    if args.save_state:
        if ckpt_mgr is not None:
            if steps_done > 0 and ckpt_mgr.latest_step() != steps_done:
                ckpt_mgr.save(steps_done, model, optimizer, rng_state, *parts[2:])
            ckpt_mgr.close()
            log.info("Saved training state to %s (latest step %d)", args.save_state, steps_done)
        else:
            save_train_state(args.save_state, model, optimizer, steps_done, rng_state,
                             *parts[2:], mesh=mesh)
            log.info("Saved training state to %s", args.save_state)
    if args.save_params:
        save_params(model, args.save_params, mesh=mesh)
        log.info("Saved serveable params to %s", args.save_params)
    if loader is not None:
        loader.close()
    log.info("Done. final loss %.5f", float(loss))
    return argparse.Namespace(model=model, optimizer=optimizer, ema=ema, losses=losses,
                              steps_done=steps_done, args=args, spec=spec, rank=rank,
                              mesh=mesh, launches=launches)



def _save_adapter_sharded(model, mesh, ema, args) -> None:
    """--save-adapter over a mesh: the PEFT directories (and OFT's aux
    files) of the gathered one-card factors, written by rank 0 from stand-in
    modules (every rank calls it)."""
    import torch
    from torch import nn

    from blurr_tpu_torch.models.pi0.checkpoint import _after_write
    from blurr_tpu_torch.ops.lora import LoRALinear, save_peft_adapter
    from blurr_tpu_torch.parallel.fsdp import gather_state, unshard_module
    from blurr_tpu_torch.utils.optim import extract_ema

    extra = None if ema is None else {"ema": extract_ema(ema, model)}
    tree, groups = gather_state(model, mesh, extra)
    if args.oft:  # the OFT modules are whole under TP; FSDP shards gather here
        aux = [unshard_module(model.action_head, mesh),
               unshard_module(model.proprio_projector, mesh) if args.use_proprio else None]
    if tree is not None:
        def llama(values):
            """The LLM's layers as ``save_peft_adapter`` reads them: each
            adapted projection a LoRALinear of the one-card factors."""
            layers = {}
            for name, t in values.items():
                parts = name.split(".")  # llama.layers.<i>.<proj>.lora_a
                if parts[:2] == ["llama", "layers"] and parts[-1] in ("lora_a", "lora_b"):
                    layers.setdefault(int(parts[2]), {}).setdefault(parts[3], {})[parts[-1]] = t
            out = nn.Module()
            out.layers = []
            for i in sorted(layers):
                layer = nn.Module()
                for proj, ab in layers[i].items():
                    s = tree[f"llama.layers.{i}.{proj}.lora_s"]
                    setattr(layer, proj, LoRALinear(nn.Identity(), ab["lora_a"], ab["lora_b"], s))
                out.layers.append(layer)
            return out

        n = save_peft_adapter(llama(tree), args.save_adapter, base_model_name=str(args.model_id))
        log.info("Exported %d LoRA factor pairs to %s (PEFT format)", n, args.save_adapter)
        if ema is not None:
            save_peft_adapter(llama({**tree, **groups["ema"]}), args.save_adapter + "_ema",
                              base_model_name=str(args.model_id))
            log.info("Exported EMA factors to %s_ema", args.save_adapter)
        if args.oft:
            from blurr_tpu_torch.models.openvla.checkpoint import save_oft_aux_params

            aux_dir = str(Path(args.save_adapter).parent)
            with torch.no_grad():
                save_oft_aux_params(aux_dir, *aux, step=args.steps)
            log.info("Exported OFT aux checkpoints to %s", aux_dir)
    _after_write(mesh)


if __name__ == "__main__":
    main()
