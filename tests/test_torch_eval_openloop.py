"""The port's Pi-0 open-loop evaluator (``scripts/eval_openloop_torch.py``)
against JAX's (``scripts/eval_openloop.py``) on the CPU.

Both read one tiny fp32 ``.pt`` that JAX's ``save_torch_checkpoint`` writes
from JAX's random bridge_tiny tree, and score the same data: synthetic, a
preprocessed ``.npz``, and a sharded dataset of raw robot-log keys (through
each package's ``transform_for_config``). Every batch is padded at the tail.
Tolerance: each float metric within ``METRIC_TOL`` absolute of JAX's; the
counts and ``gripper_agreement`` equal. The same weights and formulas summed
in another order put the actions ~1e-6 apart, and the fp32 flow noise is
JAX's within 4 ulps (``tests/test_torch_prng.py``).

Then the port alone: the padded rows are left out (the metrics equal a
recomputation over the live rows only), a ``--save-dir`` tree scores as
the ``.pt`` it was loaded from, and the missing-key exits equal JAX's.
"""

import importlib
import json
import sys

import numpy as np
import pytest
import torch

CFG = "config/eval/bridge_tiny.yaml"
METRIC_TOL = 1e-5


def _script(name):
    return importlib.import_module(f"scripts.{name}")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import jax.numpy as jnp

    from blurr_tpu import benchmarks as JB
    from blurr_tpu.models.pi0 import checkpoint as j_ckpt

    cfg = JB.load_cfg(CFG)
    _, params = JB.load_model(cfg, "random", jnp.float32)
    path = tmp_path_factory.mktemp("openloop") / "pi0.pt"
    j_ckpt.save_torch_checkpoint(params, str(path))
    return str(path)


def _run_jax(monkeypatch, tmp_path, argv):
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["eval_openloop.py", *argv, "--output-json", str(out)])
    _script("eval_openloop").main()
    return json.loads(out.read_text())


def _run_port(argv):
    return _script("eval_openloop_torch").main([*argv, "--device", "cpu"])


def _assert_metrics_match(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "per_dim_mse":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=METRIC_TOL)
        elif isinstance(v, float) and k != "gripper_agreement":
            assert abs(got[k] - v) <= METRIC_TOL, (k, got[k], v)
        else:
            assert got[k] == v, k


def _preprocessed(n, seed):
    from blurr_tpu_torch.benchmarks import load_cfg

    return _script("eval_openloop_torch")._synthetic_examples(load_cfg(CFG), n, seed)


def _raw_shards(path, n=7):
    """Raw robot-log keys (64x80 frames, raw proprio and action chunks) with
    the statistics in the manifest."""
    from blurr_tpu_torch.data import write_dataset

    rng = np.random.RandomState(5)
    pre = _preprocessed(n, 9)
    stats = {k: {"p01": [-0.3] * 7, "p99": [0.3] * 7, "mean": [0.0] * 7, "std": [0.2] * 7}
             for k in ("proprio", "action")}
    write_dataset(path, {
        "image": rng.randint(0, 256, (n, 64, 80, 3), np.uint8),
        "proprio": rng.uniform(-0.2, 0.2, (n, 7)).astype(np.float32),
        "action": rng.uniform(-0.3, 0.3, (n, 4, 7)).astype(np.float32),
        "input_ids": pre["input_ids"], "attention_mask": pre["attention_mask"],
    }, shard_size=3, statistics=stats)
    return str(path)


@pytest.mark.parametrize("data", ["synthetic", "npz", "sharded-raw"])
def test_metrics_match_jax(ckpt, tmp_path, monkeypatch, capsys, data):
    argv = ["--config", CFG, "--checkpoint", ckpt, "--examples", "5", "--batch-size", "2",
            "--act-steps", "2", "--seed", "3", "--per-dim"]
    if data == "npz":
        np.savez(tmp_path / "d.npz", **_preprocessed(9, 4))
        argv += ["--data", str(tmp_path / "d.npz")]
    elif data == "sharded-raw":
        argv += ["--data", _raw_shards(tmp_path / "raw")]
    want = _run_jax(monkeypatch, tmp_path, argv)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    got = _run_port(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    print(f"{data}: mse {got['mse']:.8f} vs JAX {want['mse']:.8f}, mae {got['mae']:.8f} vs "
          f"{want['mae']:.8f}")
    assert json.loads(lines[-1]) == got and got["examples"] == 5
    assert [line.split(":")[0] for line in lines[:-1]] == [
        line.split(":")[0] for line in jax_lines[:-1]]
    _assert_metrics_match(got, want)


def test_padded_rows_are_left_out(ckpt, monkeypatch):
    """6 examples in batches of 4: the metrics equal a recomputation that
    never pads (the live rows of each batch's step, the same noise)."""
    from blurr_tpu_torch import benchmarks as B
    from blurr_tpu_torch.ops import prng

    models = []
    real = B.load_model
    monkeypatch.setattr(B, "load_model", lambda *a: models.append(real(*a)) or models[-1])
    got = _run_port(["--config", CFG, "--checkpoint", ckpt, "--examples", "6",
                     "--batch-size", "4", "--seed", "11"])
    model = models[0]
    data = _preprocessed(6, 11 + 7)
    errs = []
    for bidx, lo in enumerate(range(0, 6, 4)):
        live = min(4, 6 - lo)
        rows = np.r_[lo:lo + live, [lo + live - 1] * (4 - live)].astype(int)
        batch = {k: v[rows] for k, v in data.items()}
        noise = prng.normal(prng.fold_in(prng.prng_key(11), bidx), (4, 4, 7))
        args = [torch.from_numpy(batch[k]) for k in
                ("input_ids", "attention_mask", "pixel_values", "proprios")]
        pred = model.infer_action(*args, noise).double().numpy()
        errs.append(pred[:live] - batch["actions"][:live].astype(np.float64))
    err = np.concatenate(errs)
    assert got["examples"] == 6
    np.testing.assert_allclose(got["per_dim_mse"], (err ** 2).mean(axis=(0, 1)), rtol=1e-12)
    assert got["mae"] == pytest.approx(np.abs(err).mean(), rel=1e-12)
    assert got["mse_prefix"] == pytest.approx((err[:, :4] ** 2).mean(), rel=1e-12)


def test_save_dir_scores_as_its_pt(ckpt, tmp_path):
    from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint, save_params
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.benchmarks import load_cfg

    model = load_checkpoint(PiZero(load_cfg(CFG), device="cpu", dtype=torch.float32), ckpt)
    save_params(model, str(tmp_path / "tree"))
    argv = ["--config", CFG, "--examples", "3", "--batch-size", "2"]
    from_pt = _run_port([*argv, "--checkpoint", ckpt])
    from_tree = _run_port([*argv, "--checkpoint", str(tmp_path / "tree")])
    assert {**from_tree, "checkpoint": ""} == {**from_pt, "checkpoint": ""}


def test_missing_key_exits_match_jax(ckpt, tmp_path, monkeypatch):
    from blurr_tpu_torch.data import write_dataset

    pre = _preprocessed(3, 1)
    np.savez(tmp_path / "no_proprio.npz", **{k: v for k, v in pre.items() if k != "proprios"})
    no_actions = tmp_path / "no_actions"
    write_dataset(no_actions, {k: v for k, v in pre.items() if k != "actions"},
                  statistics={k: {"p01": [-1.0] * 7, "p99": [1.0] * 7}
                              for k in ("proprio", "action")})
    for data in (str(tmp_path / "no_proprio.npz"), str(no_actions)):
        argv = ["--config", CFG, "--checkpoint", ckpt, "--data", data]
        with pytest.raises(SystemExit) as jexit:
            _run_jax(monkeypatch, tmp_path, argv)
        with pytest.raises(SystemExit) as texit:
            _run_port(argv)
        assert "missing keys" in str(texit.value.code)
        assert str(texit.value.code) == str(jexit.value.code)
    with pytest.raises(SystemExit, match="must be divisible by --dp 2"):
        _run_port(["--config", CFG, "--checkpoint", ckpt, "--dp", "2", "--batch-size", "3"])
