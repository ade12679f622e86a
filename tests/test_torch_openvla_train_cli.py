"""The port's OpenVLA trainer (``scripts/train_openvla_lora_torch.py``) and
open-loop evaluator (``scripts/eval_openloop_vla_torch.py``) on the CPU.

Against JAX: both trainers on one snapshot directory (the port's writer,
read by both, so the weights are carried across), the same synthetic
batches (the same seeds, and both stub tokenizers mapping words through
one CRC-32 map, so the data is the same in every process), three optimizer
steps, the adapters each exports with --save-adapter compared, the port
run at two reduction orders. JAX draws the adapters' A from PRNGKey(seed + 7)
and the port from a torch.Generator, so the port's run is given JAX's
draw. Both evaluators on one snapshot: the same metrics JSON, and the same
exits on a wrong dataset.

Then the port's CLI alone: QLoRA w4a8 and OFT with proprio from a sharded
dataset (the int4 payloads unchanged, the factors moved), --accum-steps
with --ema-decay (<dir>_ema written), exact resume from --save-state and
from a --save-every root, --save-params served by the OpenVLA server and
scored by the evaluator, .npz data, and --dp / --tp on two ranks (--fsdp
alone refused with JAX's message).
"""

import importlib
import json
import sys
import zlib

import numpy as np
import pytest
import torch

import jax

from blurr_tpu.ops import lora as j_lora
from blurr_tpu_torch.models.openvla import checkpoint as t_ckpt
from blurr_tpu_torch.models.openvla import model as t_model
from blurr_tpu_torch.models.openvla.data import write_openvla_dataset
from blurr_tpu_torch.models.pi0.checkpoint import read_safetensors
from blurr_tpu_torch.ops import lora as t_lora

# the factors after three AdamW steps (lr 5e-3), as a share of each tensor's
# largest |value|: Adam divides each gradient entry by its own running
# scale, so an entry whose gradient is small relative to its rounding
# carries that rounding into the update at full size. The bound is
# STEP_REL_TOL plus REORDER_FACTOR times the port's own spread between two
# reduction orders (one and three CPU threads): over 20 draws of the word
# map the port read up to 1.25e-3 against itself and 4.1e-3 against JAX
# (1.5e-4 and 2.6e-4 on a second draw), and no draw read over the bound.
# The spread must stay under SPREAD_MAX and the bound is capped at
# BOUND_MAX (the sweep's worst: a spread of 9.7e-4, a bound of 7.9e-3), so
# a fault that makes the port's result hang on the reduction order cannot
# widen its own tolerance past what the sweep showed
STEP_REL_TOL = 1e-4
REORDER_FACTOR = 8
SPREAD_MAX = 2e-3
BOUND_MAX = 1e-2
REORDER_THREADS = (1, 3)
EVAL_TOL = 1e-5
SEED = 3


def _script(name):
    return importlib.import_module(f"scripts.{name}")


def _snapshot(path, oft=False, seed=0):
    """A tiny fp32 snapshot drawn by the port (and OFT's aux files)."""
    spec = t_model.OpenVLASpec.tiny()
    model_cls = t_model.OpenVLAOFT if oft else t_model.OpenVLA
    kw = dict(chunk_len=2, use_proprio=True, proprio_dim=5) if oft else {}
    model = model_cls(spec, device="cpu", dtype=torch.float32, **kw)
    model.init_params(torch.Generator().manual_seed(seed))
    t_ckpt.save_openvla_snapshot(model, str(path))
    if oft:
        t_ckpt.save_oft_aux_params(str(path), model.action_head, model.proprio_projector, 1)
    return model


def _word_id(word, vocab_size):
    """The stub tokenizers' formula over a hash that is the same in every
    process (Python's ``hash`` of a string is salted per process)."""
    return zlib.crc32(word.encode()) % (vocab_size - 3000) + 3


def _stable_stub_ids(monkeypatch):
    """Both packages' ``StubLlamaTokenizer`` mapping words through
    ``_word_id``, so a test's token ids, and so its data, are the same in
    every process."""
    from blurr_tpu.models.openvla import processing as j_processing
    from blurr_tpu_torch.models.openvla import processing as t_processing

    def call(self, text, return_tensors=None):
        ids = [self.bos_token_id] + [_word_id(w, self.vocab_size) for w in text.split()]
        arr = np.array([ids], np.int32)
        return {"input_ids": arr, "attention_mask": np.ones_like(arr)}

    for mod in (j_processing, t_processing):
        monkeypatch.setattr(mod.StubLlamaTokenizer, "__call__", call)


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _script(name).main()


def test_three_steps_match_jax(tmp_path, monkeypatch):
    from blurr_tpu.models.openvla import checkpoint as j_ckpt
    from blurr_tpu.models.openvla.model import OpenVLASpec as JSpec

    _stable_stub_ids(monkeypatch)
    snap = tmp_path / "snap"
    _snapshot(snap)
    common = ["--model-id", str(snap), "--steps", "3", "--lora-rank", "4", "--dtype", "fp32",
              "--lr", "5e-3", "--warmup-steps", "1", "--seed", str(SEED), "--log-every", "1"]
    _run_jax(monkeypatch, "train_openvla_lora",
             [*common, "--save-adapter", str(tmp_path / "jax")])
    # JAX's adapter draw, carried into the port's run
    layers = j_ckpt.openvla_params_from_hf_dir(str(snap), JSpec.tiny(), np.float32)["llama"][
        "layers"]
    targets = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
    drawn = j_lora.inject_lora_tree(layers, jax.random.PRNGKey(SEED + 7), 4, targets,
                                    dtype=np.float32)
    real = t_lora.inject_lora_tree

    def jax_draw(root, *args, **kw):
        made = real(root, *args, **kw)
        with torch.no_grad():
            for i, layer in enumerate(root.layers):
                for key in targets:
                    mod = getattr(layer, t_lora.TARGET_ATTRS[key])
                    mod.lora_a.copy_(torch.from_numpy(np.asarray(drawn[key]["lora_a"][i])))
        return made

    monkeypatch.setattr(t_lora, "inject_lora_tree", jax_draw)
    threads = torch.get_num_threads()
    try:
        for n in REORDER_THREADS:
            torch.set_num_threads(n)
            run = _script("train_openvla_lora_torch").main(
                [*common, "--save-adapter", str(tmp_path / f"port{n}"), "--device", "cpu"])
            assert len(run.losses) == 3
    finally:
        torch.set_num_threads(threads)
    adapter = lambda side: read_safetensors(str(tmp_path / side / "adapter_model.safetensors"))
    theirs = adapter("jax")
    ours = [adapter(f"port{n}") for n in REORDER_THREADS]
    assert all(o.keys() == theirs.keys() for o in ours) and len(theirs) == 2 * 7 * 2
    rel = lambda a, b: max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b)
    worst = max(rel(o, theirs) for o in ours)
    spread = rel(ours[0], ours[1])
    bound = min(STEP_REL_TOL + REORDER_FACTOR * spread, BOUND_MAX)
    moved = min(float(ours[0][k].abs().max()) for k in theirs if k.endswith("lora_B.weight"))
    print(f"three steps: factors within {worst:.2e} of each one's largest |value|, the port "
          f"against itself {spread:.2e} (bound {bound:.2e}); the smallest B's largest |value| "
          f"{moved:.2e}")
    assert spread < SPREAD_MAX and worst < bound and moved > 0
    cfg = lambda side: json.loads((tmp_path / side / "adapter_config.json").read_text())
    assert {**cfg(f"port{REORDER_THREADS[0]}"), "base_model_name_or_path": ""} == {
        **cfg("jax"), "base_model_name_or_path": ""}


@pytest.mark.parametrize("oft", [False, True])
def test_open_loop_metrics_match_jax(tmp_path, monkeypatch, capsys, oft):
    snap = tmp_path / "snap"
    _snapshot(snap, oft=oft)
    argv = ["--model-id", str(snap), "--examples", "5", "--batch-size", "2", "--dtype", "fp32"]
    if oft:
        argv += ["--oft", "--chunk-len", "2", "--use-proprio", "--proprio-dim", "5"]
    _run_jax(monkeypatch, "eval_openloop_vla", argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = _script("eval_openloop_vla_torch").main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= EVAL_TOL, k
        else:
            assert got[k] == v, k


def test_open_loop_exits_match_jax(tmp_path, monkeypatch):
    snap = tmp_path / "snap"
    _snapshot(snap)
    rng = np.random.RandomState(0)
    chunked = tmp_path / "chunked"
    write_openvla_dataset(chunked, rng.randint(0, 256, (3, 28, 28, 3), np.uint8),
                          ["a", "b", "c"], rng.rand(3, 2, 7).astype(np.float32))
    from blurr_tpu_torch.data import write_dataset

    missing = tmp_path / "missing"
    write_dataset(missing, {"image": np.zeros((3, 28, 28, 3), np.uint8),
                            "action": np.zeros((3, 7), np.float32)})
    for data, extra in ((chunked, []), (chunked, ["--oft", "--chunk-len", "3"]),
                        (missing, [])):
        argv = ["--model-id", str(snap), "--data", str(data), "--dtype", "fp32", *extra]
        with pytest.raises(SystemExit) as jexit:
            _run_jax(monkeypatch, "eval_openloop_vla", argv)
        with pytest.raises(SystemExit) as texit:
            _script("eval_openloop_vla_torch").main([*argv, "--device", "cpu"])
        assert str(texit.value.code) == str(jexit.value.code)
    with pytest.raises(SystemExit, match="M14"):
        _script("eval_openloop_vla_torch").main(["--dp", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# The port's CLI alone
# ---------------------------------------------------------------------------


def _dataset(path, n=6, oft=False):
    train = _script("train_openvla_lora_torch")
    raw = train.synthetic_examples(n, 28, (2, 7) if oft else (7,), 0, proprio_dim=8 if oft else 0)
    write_openvla_dataset(path, raw["images"], raw["instructions"], raw["actions"],
                          proprios=raw.get("proprios"), shard_size=4)
    return str(path)


def _train(*argv):
    return _script("train_openvla_lora_torch").main(
        ["--device", "cpu", "--lora-rank", "2", "--log-every", "1", *argv])


@pytest.mark.parametrize("oft", [False, True])
def test_qlora_w4a8_trains_only_the_factors(tmp_path, oft):
    data = _dataset(tmp_path / "d", oft=oft)
    extra = ["--oft", "--chunk-len", "2", "--use-proprio"] if oft else []
    run = _train("--model-id", "random", "--quantize-base", "w4a8", "--data", data,
                 "--steps", "2", "--save-adapter", str(tmp_path / "out" / "lora_adapter"),
                 *extra)
    model = run.model
    fresh = _script("train_openvla_lora_torch").main(
        ["--device", "cpu", "--lora-rank", "2", "--quantize-base", "w4a8", "--steps", "0",
         *extra]).model
    before, after = dict(fresh.named_buffers()), dict(model.named_buffers())
    assert all(torch.equal(before[k], after[k]) for k in before if k.endswith((".q4", ".s")))
    assert all(np.isfinite(float(x)) for x in run.losses)
    b = [m.lora_b for m in model.modules() if isinstance(m, t_lora.LoRALinear)]
    assert len(b) == 14 and all(float(x.abs().max()) > 0 for x in b)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert any(n.startswith("action_head.") for n in trainable) == oft
    assert (tmp_path / "out" / "lora_adapter" / "adapter_model.safetensors").is_file()
    if oft:  # the head and projector beside the adapter, read back bit-equal
        head, proj = t_ckpt.load_oft_aux_params(str(tmp_path / "out"), "cpu", torch.bfloat16)
        for mine, theirs in ((model.action_head, head), (model.proprio_projector, proj)):
            a, b = mine.state_dict(), theirs.state_dict()
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_accum_and_ema_export_both_adapters(tmp_path):
    run = _train("--steps", "4", "--accum-steps", "2", "--ema-decay", "0.9", "--dtype", "fp32",
                 "--save-adapter", str(tmp_path / "lora_adapter"))
    assert run.optimizer.count == 2 and run.ema.count == 2
    live = read_safetensors(str(tmp_path / "lora_adapter" / "adapter_model.safetensors"))
    ema = read_safetensors(str(tmp_path / "lora_adapter_ema" / "adapter_model.safetensors"))
    assert live.keys() == ema.keys()
    assert any(not torch.equal(live[k], ema[k]) for k in live)


@pytest.mark.parametrize("how", ["state", "manager"])
def test_resume_is_exact(tmp_path, how):
    data = _dataset(tmp_path / "d")
    common = ["--data", data, "--steps", "4", "--quantize-base", "w8a8"]
    whole = _train(*common).model.state_dict()
    state = str(tmp_path / "state")
    first = ["--save-state", state, "--stop-after", "2"]
    if how == "manager":
        first += ["--save-every", "1", "--keep-checkpoints", "2"]
    assert _train(*common, *first).steps_done == 2
    if how == "manager":
        assert sorted(p.name for p in (tmp_path / "state").iterdir()) == ["1", "2"]
    resumed = _train(*common, "--resume-state", state)
    assert resumed.steps_done == 4 and len(resumed.losses) == 2
    got = resumed.model.state_dict()
    assert got.keys() == whole.keys() and all(torch.equal(got[k], whole[k]) for k in whole)


def test_save_params_is_served_and_scored(tmp_path, capsys):
    from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer

    data = _dataset(tmp_path / "d")
    params = str(tmp_path / "params")
    run = _train("--quantize-base", "w4a8", "--data", data, "--steps", "2", "--save-params",
                 params)
    srv = OpenVLAActionServer("random", checkpoint_path=params, device="cpu")
    mine, served = run.model.state_dict(), srv.model.state_dict()
    assert mine.keys() == served.keys() and all(torch.equal(mine[k], served[k]) for k in mine)
    img = np.random.RandomState(0).randint(0, 256, (28, 28, 3), np.uint8)
    ids, am, px = srv._prepare(img, "pick up the carrot")
    np.testing.assert_array_equal(srv._step(ids, am, px),
                                  run.model.predict_action_tokens_ragged(ids, px, am).numpy())
    metrics = _script("eval_openloop_vla_torch").main(
        ["--checkpoint", params, "--data", data, "--examples", "4", "--device", "cpu"])
    assert metrics["examples"] == 4 and metrics["checkpoint"] == params
    assert {"mse", "mae", "gripper_agreement", "token_accuracy"} <= metrics.keys()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics


def test_npz_data_trains_and_oft_checks_its_shape(tmp_path):
    raw = _script("train_openvla_lora_torch").synthetic_examples(5, 28, (7,), 1)
    np.savez(tmp_path / "d.npz", images=raw["images"], instructions=raw["instructions"],
             actions=raw["actions"])
    run = _train("--data", str(tmp_path / "d.npz"), "--steps", "2")
    assert len(run.losses) == 2 and all(np.isfinite(float(x)) for x in run.losses)
    with pytest.raises(SystemExit, match="--oft expects actions"):
        _train("--data", str(tmp_path / "d.npz"), "--oft", "--steps", "1")


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--fsdp"]])
def test_multi_card_flags_name_m14(flag):
    """M14's training half on the OpenVLA trainer: --dp 2 and --tp 2 train
    on two ranks (the same losses on each); --fsdp alone is refused with
    JAX's message."""
    if flag == ["--fsdp"]:
        with pytest.raises(SystemExit, match="needs --dp > 1"):
            _train(*flag)
        return
    run = _train(*flag, "--steps", "1")
    losses = [r["losses"] for r in run.ranks]
    assert len(losses) == 2 and losses[0] == losses[1] and np.isfinite(losses[0]).all()
