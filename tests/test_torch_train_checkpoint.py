"""The port's training checkpoints (``models/pi0/checkpoint.py``: parameter
trees, training states, ``TrainCheckpointManager``) and its training CLI
(``scripts/train_pi0_flow_torch.py``, with ``export_torch_checkpoint_torch.py``
and ``ActionServer`` on its output) on the CPU at bridge_tiny widths.

Round trips are bit-equal: a tree saved and restored into a fresh model
(rebuilt in the tree's linear kinds: quantized, adapted), a training state
with its moments, accumulator, EMA and generator; a run stopped by
--stop-after and resumed by --resume-state ends with the parameters of the
uninterrupted run. The CLI prints the JAX script's log lines; its QLoRA
--save-dir serves unmerged and answers as the trained model in memory; its
LoRA --save-dir exports to a .pt that loads bit-equal.
"""

import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blurr_tpu_torch.data import write_dataset
from blurr_tpu_torch.models.pi0 import checkpoint as ckpt
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.trainable import SCOPES, apply_mask
from blurr_tpu_torch.ops import lora as t_lora
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.parallel.train import make_train_step, sample_noise_and_t
from blurr_tpu_torch.presets import apply_preset, load_config
from blurr_tpu_torch.serving.server import ActionServer
from blurr_tpu_torch.utils import optim as t_optim

REPO_ROOT = Path(__file__).resolve().parents[1]
TINY = "config/eval/bridge_tiny.yaml"


def _cli(name):
    scripts = str(REPO_ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import importlib

    return importlib.import_module(name)


def _same(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def _model(dtype=torch.float32, quant=None, lora=False, seed=0):
    """bridge_tiny with random weights; ``quant`` quantizes both mixtures
    (w4a8 / w8a8; 'int8' the action tier with its cached-fp copy on the
    vlm's gates), ``lora`` adapts SigLIP and both mixtures."""
    model = PiZero(load_config(TINY), device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    model.init_params(g)
    if quant == "int8":
        tq.quantize_mixture_int8(model.joint["action"].layers)
        tq.quantize_dense_int8(model.joint["vlm"].layers, ("gate_proj",), cache_fp_weight=True)
    elif quant:
        for m in ("vlm", "action"):
            {"w4a8": tq.quantize_mixture_w4a8, "w8a8": tq.quantize_mixture_w8a8}[quant](
                model.joint[m].layers)
    if lora:
        for mod in (model.vision_tower, model.joint["vlm"], model.joint["action"]):
            t_lora.inject_lora_tree(mod, g, 2, ("q_w", "v_w", "fc1_w"))
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, t_lora.LoRALinear):
                    m.lora_b.normal_(generator=g)
    if dtype != torch.float32:
        t_optim.cast_floating_preserving_scales(model, dtype)
    return model


@pytest.mark.parametrize("dtype, quant, lora", [
    (torch.float32, None, False), (torch.bfloat16, "w4a8", True),
    (torch.float32, "w8a8", True), (torch.float32, None, True), (torch.bfloat16, "int8", False)])
def test_params_round_trip_bit_equal(tmp_path, dtype, quant, lora):
    """save_params then restore_params into a fresh model of the same
    dtype: the same structure (the kinds of tree.json) and the same bits;
    a fresh bf16 model takes an fp32 tree cast (the scales kept fp32)."""
    from safetensors.torch import load_file

    model = _model(dtype, quant, lora)
    ckpt.save_params(model, str(tmp_path / "p"))
    written = load_file(str(tmp_path / "p" / "params.safetensors"))  # the format's own reader
    assert all(torch.equal(written[k], t) for k, t in ckpt._state_tensors(model).items())
    fresh = PiZero(load_config(TINY), device="cpu", dtype=dtype)
    ckpt.restore_params(fresh, str(tmp_path / "p"))
    assert ckpt.linear_kinds(fresh) == ckpt.linear_kinds(model)
    assert _same(fresh, model)
    if lora or quant:
        assert any("/" in k or k != "fp" for k in ckpt.linear_kinds(fresh).values())
    if dtype == torch.float32 and quant == "w8a8":
        half = PiZero(load_config(TINY), device="cpu", dtype=torch.bfloat16)
        ckpt.load_checkpoint(half, str(tmp_path / "p"))
        q = half.joint["vlm"].layers[0].q_proj
        assert q.lora_a.dtype == torch.bfloat16 and q.base.s.dtype == torch.float32
        assert q.lora_s.dtype == torch.float32 and q.base.q8a.dtype == torch.int8


def test_restore_refuses_what_does_not_fit(tmp_path):
    ckpt.save_params(_model(quant="w4a8"), str(tmp_path / "q"))
    other = _model(quant="w8a8")
    with pytest.raises(ValueError, match="w4a8 linear where the model has a W8A8Linear"):
        ckpt.restore_params(other, str(tmp_path / "q"))
    ckpt.save_params(_model(), str(tmp_path / "p"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a parameter tree of the port"):
        ckpt.restore_params(_model(), str(tmp_path / "empty"))
    big = PiZero(load_config(TINY) | {"action_dim": 8}, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_params(big, str(tmp_path / "p"))


def _train_parts(seed=0, accum=2, ema=0.9):
    model = _model(lora=True, quant="w4a8", seed=seed)
    trainable = apply_mask(model, t_lora.lora_trainable_mask(model))
    opt = t_optim.AdamW(trainable, t_optim.warmup_cosine_decay_schedule(1e-5, 1e-3, 1, 4),
                        grad_clip=1.0)
    e = t_optim.ParamsEMA(trainable, ema)
    step = make_train_step(model, opt, accum_steps=accum, ema=e)
    return model, opt, e, step


def _run_steps(step, n, gen, seed=0):
    cfg = load_config(TINY)
    batch = _cli("train_pi0_flow_torch").synthetic_batch(cfg, 2, np.random.RandomState(seed))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(n):
        step(tb, *sample_noise_and_t(gen, tb["actions"]))


def test_train_state_round_trip_bit_equal(tmp_path):
    """3 micro-steps (accumulation 2: one update, one half-accumulated),
    saved with the generator; a fresh model, optimizer, accumulator and EMA
    restored from it take the same next 3 micro-steps as the original."""
    model, opt, ema, step = _train_parts()
    gen = torch.Generator().manual_seed(1)
    _run_steps(step, 3, gen)
    ckpt.save_train_state(str(tmp_path / "s"), model, opt, 3, gen.get_state(),
                          step.accumulator, ema)
    fresh, opt2, ema2, step2 = _train_parts(seed=5)
    n, rng = ckpt.restore_train_state(str(tmp_path / "s"), fresh, opt2, step2.accumulator, ema2)
    gen2 = torch.Generator().set_state(rng)
    assert n == 3 and _same(fresh, model) and opt2.count == opt.count == 1
    assert step2.accumulator.mini_step == 1 and ema2.count == 1
    _run_steps(step, 3, gen, seed=1)
    _run_steps(step2, 3, gen2, seed=1)
    assert _same(fresh, model)
    assert all(torch.equal(a, b) for a, b in zip(ema.ema, ema2.ema))
    with pytest.raises(ValueError, match="ema state"):
        other, o3, _, s3 = _train_parts()
        ckpt.restore_train_state(str(tmp_path / "s"), other, o3, s3.accumulator, None)


def test_manager_keeps_the_newest_and_skips_an_incomplete_step(tmp_path):
    model, opt, ema, step = _train_parts(accum=1)
    gen = torch.Generator().manual_seed(0)
    root = tmp_path / "root"
    mgr = ckpt.TrainCheckpointManager(str(root), keep=2)
    for i in range(1, 6):
        _run_steps(step, 1, gen)
        mgr.save(i, model, opt, gen.get_state(), None, ema)
    assert mgr.latest_step() == 5 and mgr.steps() == [4, 5]
    (root / "9").mkdir()  # an interrupted write: files, no state.json
    (root / "9" / "params.safetensors").write_bytes(b"partial")
    assert mgr.latest_step() == 5
    assert ckpt.is_manager_root(str(root)) and not ckpt.is_manager_root(str(root / "5"))
    fresh, opt2, ema2, _ = _train_parts(accum=1, seed=3)
    n, _ = mgr.restore(fresh, opt2, None, ema2)
    mgr.close()
    assert n == 5 and _same(fresh, model) and opt2.count == 5
    assert sorted(os.listdir(root)) == ["4", "5", "9"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A raw sharded dataset for bridge_tiny: 40x48 frames (resized to 56),
    raw proprio and actions (the config's statistics), 12 examples."""
    cfg = load_config(TINY)
    rng = np.random.RandomState(0)
    n, seq, n_img = 12, cfg["max_image_text_tokens"], cfg["vision"]["config"]["num_image_tokens"]
    ids = np.zeros((n, seq), np.int32)
    ids[:, :n_img] = cfg["image_token_index"]
    ids[:, n_img:n_img + 5] = rng.randint(3, 1000, (n, 5))
    am = (ids != 0).astype(np.int32)
    path = tmp_path_factory.mktemp("data") / "ds"
    write_dataset(path, {
        "image": rng.randint(0, 256, (n, 40, 48, 3), np.uint8),
        "proprio": rng.uniform(-0.2, 0.2, (n, 7)).astype(np.float32),
        "action": rng.uniform(-0.02, 0.02, (n, 4, 7)).astype(np.float32),
        "input_ids": ids, "attention_mask": am}, shard_size=5)
    return str(path)


MODES = {"plain": [], "lora": ["--lora-rank", "4"],
         "qlora": ["--lora-rank", "4", "--lora-quantize-base", "w4a8", "--dtype", "bf16"]}


def _main(argv, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        return _cli("train_pi0_flow_torch").main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("data", ["synthetic", "sharded"])
def test_cli_trains_and_saves(tmp_path, caplog, shards, mode, data):
    argv = ["--config", TINY, "--steps", "3", "--log-every", "1", "--data",
            shards if data == "sharded" else "synthetic", *MODES[mode],
            "--save-dir", str(tmp_path / "out")]
    result = _main(argv, caplog)
    text = caplog.text
    assert "Trainable parameters: " in text
    assert "step 0/3 loss " in text and " lr " in text and "step 2/3 loss" in text
    assert "Saved params to" in text and "Done. final loss" in text
    assert (data == "sharded") == ("(raw keys -> Pi0TrainTransform)" in text)
    assert (tmp_path / "out" / "tree.json").is_file()
    assert len(result.losses) == 3 and all(np.isfinite(float(x)) for x in result.losses)
    kinds = set(ckpt.linear_kinds(ckpt.restore_params(
        PiZero(load_config(TINY), device="cpu", dtype=torch.float32),
        str(tmp_path / "out"))).values())
    # LoRA is merged into plain weights; QLoRA keeps its adapters: over int4
    # in the mixtures, over fp weights in SigLIP
    assert kinds == ({"lora/fp", "lora/w4a8", "w4a8"} if mode == "qlora" else set())


def test_qlora_save_dir_serves_as_the_model_in_memory(tmp_path, caplog):
    result = _main(["--config", TINY, "--steps", "2", *MODES["qlora"],
                    "--save-dir", str(tmp_path / "q")], caplog)
    assert "QLoRA: saving the adapter tree unmerged" in caplog.text
    cfg = load_config(TINY)
    apply_preset(cfg, "blurr")
    server = ActionServer(cfg, str(tmp_path / "q"), device="cpu")
    assert isinstance(server.model.joint["vlm"].layers[0].q_proj.base, tq.W4A8Linear)
    image = np.random.RandomState(0).randint(0, 256, (56, 56, 3), np.uint8)
    got = server.predict(image, "pick up the spoon", [0.1] * 7)
    inputs = server._prepare(image, "pick up the spoon", [0.1] * 7)
    with torch.no_grad():
        want = result.model.infer_action(*inputs, server.noise(0),
                                         server.model.spec.num_inference_steps)
    np.testing.assert_array_equal(got, want[0].float().numpy())
    assert got.shape == (4, 7) and np.isfinite(got).all()


def test_lora_save_dir_exports_to_a_pt(tmp_path, caplog):
    _main(["--config", TINY, "--steps", "2", *MODES["lora"], "--save-dir", str(tmp_path / "l")],
          caplog)
    _cli("export_torch_checkpoint_torch").main(["--config", TINY, "--params",
                                                str(tmp_path / "l"), "--out",
                                                str(tmp_path / "l.pt"), "--device", "cpu"])
    from_pt = ckpt.load_checkpoint(PiZero(load_config(TINY), device="cpu",
                                          dtype=torch.float32), str(tmp_path / "l.pt"))
    from_dir = ckpt.load_checkpoint(PiZero(load_config(TINY), device="cpu",
                                           dtype=torch.float32), str(tmp_path / "l"))
    assert _same(from_pt, from_dir)
    ckpt.save_params(_model(quant="w4a8", lora=True), str(tmp_path / "q"))
    with pytest.raises(ValueError, match="quantized base"):
        _cli("export_torch_checkpoint_torch").main(["--config", TINY, "--params",
                                                    str(tmp_path / "q"), "--out",
                                                    str(tmp_path / "q.pt"), "--device", "cpu"])


@pytest.mark.parametrize("manager", [True, False])
def test_stop_after_then_resume_state_ends_as_uninterrupted(tmp_path, caplog, shards, manager):
    """QLoRA w4a8, accumulation 2, EMA, clip: 6 micro-steps in one run, or
    3 then a resume to 6 (a --save-every manager root, or one
    --save-state directory): the same parameters and EMA, bit for bit."""
    base = ["--config", TINY, "--steps", "6", "--data", shards if manager else "synthetic",
            *MODES["qlora"], "--accum-steps", "2", "--ema-decay", "0.9", "--grad-clip", "1",
            "--log-every", "1"]
    whole = _main([*base, "--save-dir", str(tmp_path / "whole")], caplog)
    state = str(tmp_path / "state")
    stop = ["--save-state", state, "--stop-after", "3"]
    if manager:
        stop += ["--save-every", "2", "--keep-checkpoints", "2"]
    _main([*base, *stop], caplog)
    assert "Stopping after 3 steps (--stop-after)" in caplog.text
    assert ckpt.is_manager_root(state) == manager
    resumed = _main([*base, "--resume-state", state, "--save-dir", str(tmp_path / "resumed")],
                    caplog)
    assert "Resumed training state from" in caplog.text and "at step 3" in caplog.text
    assert len(resumed.losses) == 3
    assert [float(x) for x in resumed.losses] == [float(x) for x in whole.losses[3:]]
    assert _same(resumed.model, whole.model)
    for suffix in ("", "_ema"):
        a = ckpt.read_safetensors(str(tmp_path / f"whole{suffix}" / "params.safetensors"))
        b = ckpt.read_safetensors(str(tmp_path / f"resumed{suffix}" / "params.safetensors"))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_cli_validation_and_metrics_csv(tmp_path, caplog, shards):
    csv_path = tmp_path / "m.csv"
    _main(["--config", TINY, "--steps", "2", "--data", shards, "--val-examples", "4",
           "--val-every", "1", "--dtype", "master-fp32", "--train-scope", "action_expert",
           "--metrics-csv", str(csv_path), "--log-every", "1"], caplog)
    text = caplog.text
    assert "Validation split: 4 examples (2 batches of 2)" in text
    assert "step 0 validation loss" in text and "Final validation loss" in text
    rows = csv_path.read_text().splitlines()
    assert rows[0] == "step,loss,lr,wall_s,samples_per_s,val_loss" and len(rows) == 3
    with pytest.raises(SystemExit, match="sharded dataset"):
        _main(["--config", TINY, "--steps", "1", "--val-examples", "2"], caplog)


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--sp", "2"], ["--pp", "2"],
                                   ["--fsdp"], ["--multihost"]])
def test_cli_refuses_multi_card_flags(flags, caplog):
    """The parallel flags as JAX's trainer takes them: --dp 2, --tp 2,
    --sp 2 and --pp 2 (on bridge_tiny_pp, whose 4 joint layers split over
    2 stages) train on two ranks (the same loss on each); --sp and --pp
    refuse the combinations JAX refuses, with its message; --fsdp alone is
    refused with JAX's message; --multihost without a launcher trains on
    one process."""
    config = "config/eval/bridge_tiny_pp.yaml" if flags[0] == "--pp" else TINY
    argv = ["--config", config, "--steps", "1", *flags]
    if flags[0] == "--fsdp":
        with pytest.raises(SystemExit, match="needs --dp > 1") as err:
            _main(argv, caplog)
        assert err.value.code != 0
        return
    if flags[0] in ("--sp", "--pp"):
        other = ["--pp", "2"] if flags[0] == "--sp" else ["--tp", "2"]
        with pytest.raises(SystemExit) as err:
            _main(argv + other, caplog)
        assert str(err.value) == "--pp composes with --dp only; drop --tp/--sp/--fsdp"
    result = _main(argv, caplog)
    losses = [r["losses"] for r in result.ranks]
    assert len(losses) == (1 if flags == ["--multihost"] else 2)
    assert all(r == losses[0] for r in losses) and np.isfinite(losses[0]).all()


def test_full_fine_tuning_scopes_freeze_the_rest(caplog):
    """--train-scope vlm: the token embedding and the action expert stay
    bit-unchanged; the vision tower, the projector and the vlm mixture
    move (all but what no gradient reaches: the last vlm layer's output
    side, whose zero-initialized norm scales stay 0 under weight decay)."""
    result = _main(["--config", TINY, "--steps", "2", "--train-scope", "vlm"], caplog)
    before = PiZero(load_config(TINY), device="cpu", dtype=torch.float32)
    before.init_params(torch.Generator().manual_seed(42))
    mask = SCOPES["vlm"](before)
    after = dict(result.model.named_parameters())
    moved = {n: not torch.equal(p, after[n].detach()) for n, p in before.named_parameters()}
    assert not any(moved[n] for n in mask if not mask[n])
    assert all(moved[n] for n in mask if mask[n] and not n.startswith("joint.vlm.layers.2."))
    assert {n.split(".")[0] for n in mask if mask[n]} == {
        "vision_tower", "multi_modal_projector", "joint"}
