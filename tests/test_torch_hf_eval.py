"""The port's OpenVLA-family eval CLIs, ``scripts/eval_hf_vla_simpler_torch.py``
and ``scripts/eval_prismatic_vla_simpler_torch.py``, against the JAX
package's on files both read, on the fake env with a recording ``make_env``
patched into both packages' ``fake_env`` modules.

- The HF CLI on one synthetic tiny snapshot
  (``tests/test_openvla_checkpoint.synth_hf_snapshot``, with a
  ``blurr_spec.json``, a ``config.json`` ``norm_stats`` for ``bridge_orig``
  and a ``dataset_statistics.json`` for ``bridge_dataset``, so the
  injection runs): ``--preset baseline`` (fp32) with quantization none,
  w8a8 and w4a8; OFT (an action head of chunk 2) with a proprio projector
  of 7 and of 8 inputs; ``--center-crop on`` with ``--image-preproc raw``
  and ``--num-steps-wait 1``; ``episode_id`` resets.
- The prismatic CLI on a tiny ``.pt`` in the ``run_dir/checkpoints/``
  layout beside a ``dataset_statistics.json``, ``--fp32``; and
  ``--checkpoint random`` (the summary's keys only: the two packages draw
  random weights from different generators). Both scripts'
  ``minivla_spec`` is patched to ``tiny_minivla``.

Every env action is equal (the token path), or within 1e-5 on the OFT
path (continuous fp32 chunks); ``summary.json`` is equal but for ``dtype``
and ``torch_compile`` (the known differences: the frameworks' dtype names,
and the port runs eagerly), and so are the episode and success log lines.
"""

import dataclasses
import importlib
import json
import re
import sys

import numpy as np
import pytest
import torch

from blurr_tpu.agent import fake_env as j_fake_env
from blurr_tpu_torch.agent import fake_env as t_fake_env
from blurr_tpu_torch.models.openvla.model import OpenVLASpec

OFT_TOL = 1e-5
TASK = "fake_widowx_carrot_on_plate"
KNOWN_DIFFERENCES = ("dtype", "torch_compile")
LOG_LINE = re.compile(r"\| (\[.*(?:Episode \d+ finished|Success rate).*)$")
CONFIG_STATS = {"bridge_orig": {"action": {
    "q01": [-0.12, -0.1, -0.11, -0.3, -0.25, -0.2, 0.0],
    "q99": [0.13, 0.11, 0.1, 0.28, 0.26, 0.22, 1.0],
    "mask": [True] * 6 + [False]}}}
DATASET_STATS = {"bridge_dataset": {
    "action": {"q01": [-1.0] * 7, "q99": [1.0] * 7, "mean": [0.0] * 7},
    "proprio": {"q01": [0.0, 0.0, 0.0, -3.0, -3.0, -3.0, 0.0, 0.0],
                "q99": [0.3, 0.3, 0.3, 3.0, 3.0, 3.0, 1.0, 1.0]}}}


def _script(name):
    return importlib.import_module(f"scripts.{name}")


def _recording_make_env(module, sink):
    class Recording(module.FakeSimplerEnv):
        def step(self, action):
            sink.append(np.array(action, np.float64, copy=True))
            return super().step(action)

    return lambda task: Recording(task)


def _run(monkeypatch, tmp_path, jax_script, torch_script, argv, tag):
    """Both CLIs on ``argv`` (the port's with ``--device cpu``): per side,
    (env actions, summary.json, the episode and success log lines)."""
    out = {}
    for side, module, script in (("jax", j_fake_env, jax_script),
                                 ("torch", t_fake_env, torch_script)):
        sink = []
        monkeypatch.setattr(module, "make_env", _recording_make_env(module, sink))
        log_dir = tmp_path / f"{tag}_{side}"
        args = [*argv, "--log-dir", str(log_dir)]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [f"{jax_script}.py", *args])
            _script(jax_script).main()
        else:
            _script(torch_script).main([*args, "--device", "cpu"])
        lines = [m.group(1) for m in map(LOG_LINE.search,
                                         (log_dir / "run.log").read_text().splitlines()) if m]
        out[side] = (sink, json.loads((log_dir / "summary.json").read_text()), lines)
    return out


def _same(out, tol=0.0, values=True):
    """The port's run against JAX's: as many env actions, each equal (within
    ``tol`` where given), summary.json's keys, and with ``values`` its
    values but the known differences and the log lines."""
    (ja, js, jl), (ta, ts, tl) = out["jax"], out["torch"]
    assert len(ta) == len(ja) > 0
    assert ts.keys() == js.keys()
    assert ts["dtype"].startswith("torch.")
    if values:
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        strip = lambda s: {k: v for k, v in s.items() if k not in KNOWN_DIFFERENCES}
        assert strip(ts) == strip(js)
        assert tl == jl and any("Success rate" in line for line in tl)
    return ta


# ---------------------------------------------------------------------------
# The HF CLI
# ---------------------------------------------------------------------------


def _oft_files(path, spec, proprio_dim, chunk_len=2, seed=5):
    """An OFT action head of ``chunk_len`` and a proprio projector of
    ``proprio_dim`` inputs, as the reference's checkpoints."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))
    hidden = spec.llama.hidden_size
    n_tok = chunk_len * spec.action_dim
    in_dim = n_tok * hidden
    head = {"module.model.layer_norm1.weight": 1 + t(in_dim),
            "module.model.layer_norm1.bias": t(in_dim),
            "module.model.fc1.weight": t(hidden, in_dim), "module.model.fc1.bias": t(hidden),
            "module.model.layer_norm2.weight": 1 + t(hidden),
            "module.model.layer_norm2.bias": t(hidden),
            "module.model.fc2.weight": t(n_tok, hidden), "module.model.fc2.bias": t(n_tok)}
    for i in range(2):
        head[f"module.model.mlp_resnet_blocks.{i}.ffn.0.weight"] = 1 + t(hidden)
        head[f"module.model.mlp_resnet_blocks.{i}.ffn.0.bias"] = t(hidden)
        head[f"module.model.mlp_resnet_blocks.{i}.ffn.1.weight"] = t(hidden, hidden)
        head[f"module.model.mlp_resnet_blocks.{i}.ffn.1.bias"] = t(hidden)
    torch.save(head, path / "action_head--1000_checkpoint.pt")
    torch.save({"module.fc1.weight": t(hidden, proprio_dim), "module.fc1.bias": t(hidden),
                "module.fc2.weight": t(hidden, hidden), "module.fc2.bias": t(hidden)},
               path / "proprio_projector--1000_checkpoint.pt")


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from tests.test_openvla_checkpoint import synth_hf_snapshot

    spec = OpenVLASpec.tiny()
    path = tmp_path_factory.mktemp("hf_snapshot")
    synth_hf_snapshot(path, spec)
    (path / "blurr_spec.json").write_text(json.dumps(dataclasses.asdict(spec)))
    (path / "config.json").write_text(json.dumps({"norm_stats": CONFIG_STATS}))
    (path / "dataset_statistics.json").write_text(json.dumps(DATASET_STATS))
    return path


def _hf(monkeypatch, tmp_path, argv, tag):
    return _run(monkeypatch, tmp_path, "eval_hf_vla_simpler", "eval_hf_vla_simpler_torch",
                ["--task", TASK, "--n-eval-episode", "1", "--max-steps", "3", *argv], tag)


@pytest.mark.parametrize("quant", ["none", "w8a8", "w4a8"])
def test_hf_cli_matches_jax(snapshot, tmp_path, monkeypatch, quant):
    out = _hf(monkeypatch, tmp_path,
              ["--model-id", str(snapshot), "--preset", "baseline", "--quantization", quant], quant)
    actions = _same(out)
    assert len(actions) == 3
    assert all(a[6] in (-1.0, 1.0) for a in actions)


@pytest.mark.parametrize("proprio_dim", [7, 8])
def test_hf_cli_oft_matches_jax(tmp_path, monkeypatch, snapshot, proprio_dim):
    """OFT with a proprio projector: the proprio map by the projector's
    width (Bridge's 7D, or the padded 8D), normalized by the injected
    bridge_dataset proprio statistics (8 long: the 7D map is left as it
    is); each [2, 7] chunk run action by action until max_steps."""
    import shutil

    oft = tmp_path / "oft"
    shutil.copytree(snapshot, oft)
    _oft_files(oft, OpenVLASpec.tiny(), proprio_dim)
    cli, built = _script("eval_hf_vla_simpler_torch"), []
    real = cli._build_model
    monkeypatch.setattr(cli, "_build_model", lambda *a: built.append(real(*a)) or built[-1])
    out = _hf(monkeypatch, tmp_path, ["--model-id", str(oft), "--preset", "baseline"],
              f"oft{proprio_dim}")
    actions = _same(out, OFT_TOL)
    assert len(actions) == 3  # a chunk of 2, then the first action of the next
    model, *_, is_oft, proprio_in = built[0]
    assert is_oft and model.chunk_len == 2 and proprio_in == proprio_dim


def test_hf_cli_crop_raw_and_wait_match_jax(snapshot, tmp_path, monkeypatch):
    out = _hf(monkeypatch, tmp_path,
              ["--model-id", str(snapshot), "--preset", "baseline", "--center-crop", "on",
               "--image-preproc", "raw", "--num-steps-wait", "1"], "crop")
    actions = _same(out)
    np.testing.assert_array_equal(actions[0], [0, 0, 0, 0, 0, 0, -1])  # the settle step
    assert len(actions) == 4


def test_hf_cli_episode_id_resets_match_jax(snapshot, tmp_path, monkeypatch):
    out = _run(monkeypatch, tmp_path, "eval_hf_vla_simpler", "eval_hf_vla_simpler_torch",
               ["--model-id", str(snapshot), "--preset", "baseline", "--task", TASK,
                "--n-eval-episode", "2", "--max-steps", "2", "--initial-states", "episode_id"],
               "episode_id")
    _same(out)
    assert out["torch"][1]["per_task_success"] == {TASK: 0.0}


def test_hf_cli_random_runs_and_refuses_lora(tmp_path, snapshot):
    cli = _script("eval_hf_vla_simpler_torch")
    cli.main(["--model-id", "random", "--task", TASK, "--n-eval-episode", "1",
              "--max-steps", "2", "--device", "cpu", "--quantization", "w4a8",
              "--use-torch-compile", "--log-dir", str(tmp_path / "random")])
    log = (tmp_path / "random" / "run.log").read_text()
    assert "Success rate:" in log and "have no effect" in log
    import shutil

    # a snapshot's lora_adapter/ merges as it loads (it was refused before
    # the PEFT half was ported); --use-lora off leaves it out
    from blurr_tpu.ops.lora import save_peft_adapter

    lora = tmp_path / "lora"
    shutil.copytree(snapshot, lora)
    spec = OpenVLASpec.tiny().llama
    rng = np.random.RandomState(0)
    n, h = spec.num_layers, spec.hidden_size
    save_peft_adapter({"v_w": {"lora_a": rng.randn(n, h, 2).astype(np.float32),
                               "lora_b": rng.randn(n, 2, spec.num_kv_heads * spec.head_dim
                                                   ).astype(np.float32),
                               "lora_s": np.ones((n,), np.float32)}},
                      str(lora / "lora_adapter"))
    argv = ["--model-id", str(lora), "--task", TASK, "--n-eval-episode", "1", "--max-steps",
            "1", "--device", "cpu"]
    for flag, tag in (("auto", "lora_on"), ("off", "lora_off")):
        cli.main([*argv, "--use-lora", flag, "--log-dir", str(tmp_path / tag)])
        assert "Success rate:" in (tmp_path / tag / "run.log").read_text()


# ---------------------------------------------------------------------------
# The prismatic CLI
# ---------------------------------------------------------------------------


def _tiny_minivla(vocab_size=32064):
    spec = OpenVLASpec.tiny_minivla()
    return dataclasses.replace(spec, llama=dataclasses.replace(spec.llama,
                                                               vocab_size=vocab_size))


@pytest.fixture
def tiny_prismatic(monkeypatch):
    from blurr_tpu.models.openvla.model import OpenVLASpec as JSpec

    def jax_spec(vocab_size=32064):
        spec = JSpec.tiny_minivla()
        return dataclasses.replace(spec, llama=dataclasses.replace(spec.llama,
                                                                   vocab_size=vocab_size))

    monkeypatch.setattr(_script("eval_prismatic_vla_simpler"), "minivla_spec", jax_spec)
    monkeypatch.setattr(_script("eval_prismatic_vla_simpler_torch"), "minivla_spec",
                        _tiny_minivla)


def _prismatic_pt(tmp_path):
    """A tiny prismatic ``.pt`` (Qwen2 LLM with q/k/v biases and a tied
    head, one SigLIP tower, a 2-linear projector) in the run_dir layout."""
    from tests.test_torch_openvla_checkpoint import _llama_state, _vit_state

    spec = _tiny_minivla()
    rng = np.random.RandomState(3)
    state = _llama_state(spec.llama, "llm_backbone.llm.", rng, qwen=True)
    state.update(_vit_state("vision_backbone.featurizer.", spec.siglip, rng, False))
    h = spec.llama.hidden_size
    for i, din in ((0, spec.siglip.hidden_size), (2, h)):
        state[f"projector.projector.{i}.weight"] = torch.from_numpy(
            (rng.randn(h, din) * 0.05).astype(np.float32))
        state[f"projector.projector.{i}.bias"] = torch.from_numpy(
            (rng.randn(h) * 0.05).astype(np.float32))
    run = tmp_path / "run_dir"
    (run / "checkpoints").mkdir(parents=True)
    stats = {"my_dataset": {"action": {"q01": [-0.2] * 7, "q99": [0.3] * 6 + [1.0],
                                       "mask": [True] * 6 + [False]}}}
    (run / "dataset_statistics.json").write_text(json.dumps(stats))
    path = run / "checkpoints" / "step-000100.pt"
    torch.save({"model": state}, path)
    return path


def test_prismatic_cli_matches_jax(tmp_path, monkeypatch, tiny_prismatic, caplog):
    path = _prismatic_pt(tmp_path)
    out = _run(monkeypatch, tmp_path, "eval_prismatic_vla_simpler",
               "eval_prismatic_vla_simpler_torch",
               ["--checkpoint", str(path), "--task", TASK, "--n-eval-episode", "1",
                "--max-steps", "3", "--fp32"], "prismatic")
    actions = _same(out)
    assert out["torch"][1]["unnorm_key"] == "my_dataset"
    assert all(a[6] in (-1.0, 1.0) for a in actions)
    log = (tmp_path / "prismatic_torch" / "run.log").read_text()
    assert "Loaded from" in log and "llama, siglip+projector" in log
    assert "PARTIAL LOAD" not in log


def test_prismatic_cli_partial_load_warns(tmp_path, tiny_prismatic):
    """A state dict without the vision tower: the LLM loads, the tower and
    projector stay random, with the "PARTIAL LOAD" warning."""
    path = _prismatic_pt(tmp_path)
    state = torch.load(path, weights_only=True)["model"]
    torch.save({k: v for k, v in state.items() if not k.startswith("vision_backbone.")}, path)
    _script("eval_prismatic_vla_simpler_torch").main(
        ["--checkpoint", str(path), "--task", TASK, "--n-eval-episode", "1", "--max-steps", "1",
         "--device", "cpu", "--log-dir", str(tmp_path / "partial")])
    log = (tmp_path / "partial" / "run.log").read_text()
    assert "Loaded from" in log and "PARTIAL LOAD: siglip+projector" in log


def test_prismatic_cli_random_summary_keys(tmp_path, monkeypatch, tiny_prismatic):
    out = _run(monkeypatch, tmp_path, "eval_prismatic_vla_simpler",
               "eval_prismatic_vla_simpler_torch",
               ["--checkpoint", "random", "--task", TASK, "--n-eval-episode", "1",
                "--max-steps", "2"], "prismatic_random")
    _same(out, values=False)
    js, ts = out["jax"][1], out["torch"][1]
    assert ts["unnorm_key"] == js["unnorm_key"] == "bridge_orig"
    assert ts["dtype"] == "torch.bfloat16"


def test_prismatic_state_dict_round_trips_through_the_cli_loader(tmp_path, tiny_prismatic):
    """The CLI's ``prismatic_state_dict`` writes the keys its loader
    reads: a tiny MiniVLA saved and loaded back bit for bit, and JAX's
    readers take the same keys."""
    from blurr_tpu.models.openvla import checkpoint as j_ckpt
    from blurr_tpu_torch.models.openvla.model import OpenVLA

    cli = _script("eval_prismatic_vla_simpler_torch")
    prismatic_state_dict = cli.prismatic_state_dict
    drawn = OpenVLA(_tiny_minivla(), device="cpu", dtype=torch.float32)
    drawn.init_params(torch.Generator().manual_seed(4))
    path = tmp_path / "step.pt"
    torch.save({"model": {k: v.detach().contiguous() for k, v in
                          prismatic_state_dict(drawn).items()}}, path)
    state, _ = cli._read_checkpoint(str(path))
    spec = cli._spec_of(state)
    assert spec == drawn.spec
    fresh = OpenVLA(spec, device="cpu", dtype=torch.float32)
    fresh.init_params(torch.Generator().manual_seed(5))
    cli._load_state(fresh, state, str(path))
    want = dict(drawn.named_parameters())
    assert all(torch.equal(p, want[k]) for k, p in fresh.named_parameters())
    j_ckpt.llama_params_from_hf({k: v for k, v in state.items()}, prefix="llm_backbone.llm.")
    j_ckpt.prismatic_vision_params(state, spec)
    with pytest.raises(ValueError, match="one vision tower"):
        prismatic_state_dict(OpenVLA(OpenVLASpec.tiny(), device="meta", dtype=torch.float32))
