"""The trainers' parallel flags on the CPU (``scripts/train_pi0_flow_torch.py``,
``scripts/train_openvla_lora_torch.py``) at bridge_tiny widths.

Three optimizer steps of full fine-tuning at ``--dp 2`` and at ``--tp 2``
against ``--dp 1``: the logged losses and the saved one-card trees within
JAX's meshed-against-single-device bound (``rtol=5e-4, atol=5e-5``; the
row sums and the data ranks' gradient sum change the order of addition).
A ``--tp 2`` run stopped after one step with ``--save-state`` saves the
gathered tree: it loads into a one-card model, and cut back to rank 0's
slices it equals what rank 0 held, bit for bit; resumed by
``--resume-state`` it ends with the uninterrupted run's saved tree, bit
for bit. The runs go in parallel: the interrupted one in this process
(rank 0 here, its other rank spawned), the others as subprocesses, every
process on one thread, so the resumed run and the uninterrupted one add
in the same order. Then JAX's checks and messages:
``--multihost`` without a launcher is JAX's warning and a one-process
run; ``--fsdp`` without ``--dp > 1``, ``--pp`` with ``--sp`` or ``--tp``,
OpenVLA's ``--tp`` with w4a8, word for word.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blurr_tpu_torch.models.pi0.checkpoint import read_safetensors, restore_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.trainable import SCOPES
from blurr_tpu_torch.parallel import fsdp as t_fsdp
from blurr_tpu_torch.parallel import mesh as t_mesh
from blurr_tpu_torch.presets import load_config

REPO_ROOT = Path(__file__).resolve().parents[1]
TINY = "config/eval/bridge_tiny.yaml"
JAX_RTOL, JAX_ATOL = 5e-4, 5e-5
RUN_DEADLINE_S = 600.0
BASE = ["--config", TINY, "--device", "cpu", "--steps", "3", "--log-every", "1"]


def _cli(name):
    scripts = str(REPO_ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import importlib

    return importlib.import_module(name)


def _popen(argv, log):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, str(REPO_ROOT / "scripts" / "train_pi0_flow_torch.py"),
                             *argv], cwd=REPO_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait(proc, log_path):
    if proc.wait(RUN_DEADLINE_S) != 0:
        raise RuntimeError(f"{proc.args[2:]} exited {proc.returncode}:\n"
                           f"{Path(log_path).read_text()[-3000:]}")


def _losses(csv_path):
    rows = Path(csv_path).read_text().splitlines()[1:]
    return [float(r.split(",")[1]) for r in rows]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's output directory: dp1, dp2 and the uninterrupted tp2 run
    as subprocesses, the tp2 run interrupted after one step here (rank 0
    in this process), then its resumption as a subprocess."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs = {}
    for name, extra in (("dp1", []), ("dp2", ["--dp", "2"]), ("tp2", ["--tp", "2"])):
        log = tmp / f"{name}.log"
        procs[name] = (_popen(BASE + extra + ["--save-dir", str(tmp / name), "--metrics-csv",
                                              str(tmp / f"{name}.csv")], open(log, "w")), log)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            stopped = _cli("train_pi0_flow_torch").main(
                BASE + ["--tp", "2", "--stop-after", "1", "--save-state", str(tmp / "state")])
    finally:
        torch.set_num_threads(threads)
    log = tmp / "tp2_resume.log"
    resume = (_popen(BASE + ["--tp", "2", "--resume-state", str(tmp / "state"), "--save-dir",
                             str(tmp / "tp2_resume")], open(log, "w")), log)
    for proc in (*procs.values(), resume):
        _wait(*proc)
    return tmp, stopped


def _tree(path):
    return {k: v.numpy() for k, v in read_safetensors(str(path / "params.safetensors")).items()}


@pytest.mark.parametrize("flag", ["dp2", "tp2"])
def test_dp2_and_tp2_follow_dp1_over_three_steps(runs, flag):
    tmp, _ = runs
    want_losses, got_losses = _losses(tmp / "dp1.csv"), _losses(tmp / f"{flag}.csv")
    assert len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=JAX_RTOL, atol=JAX_ATOL)
    want, got = _tree(tmp / "dp1"), _tree(tmp / flag)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=name)


def test_tp2_save_is_the_gathered_tree(runs):
    """The tp=2 run's saved state holds the one-card tree: it loads into a
    one-card model, and cut back to rank 0's slices it equals what rank 0
    held when it saved, bit for bit; both ranks logged the same loss."""
    tmp, stopped = runs
    assert [r["losses"] for r in stopped.ranks] == [[float(x) for x in stopped.losses]] * 2
    one = PiZero(load_config(TINY), device="cpu", dtype=torch.float32)
    restore_params(one, str(tmp / "state"))  # loads on one card
    full = {**dict(one.named_parameters()), **dict(one.named_buffers())}
    where = t_fsdp.layout(stopped.model, stopped.mesh)
    held = t_fsdp.state_tensors(stopped.model)
    assert {w.name for w in where.values()} == set(full)
    assert any(w.tp_axis is not None for w in where.values())
    for name, t in held.items():
        assert torch.equal(t_fsdp.cut_tensor(full[where[name].name], where[name], t,
                                             stopped.mesh), t.detach()), name


def test_tp2_resume_state_is_bit_equal(runs):
    tmp, _ = runs
    want, got = _tree(tmp / "tp2"), _tree(tmp / "tp2_resume")
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


def test_multihost_without_a_launcher_is_jax_warning(caplog, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with caplog.at_level(logging.INFO):
        run = _cli("train_pi0_flow_torch").main(BASE[:-4] + ["--steps", "1", "--multihost"])
    assert "continuing single-process (process_count=1)" in caplog.text
    assert run.mesh is None and len(run.losses) == 1 and not torch.distributed.is_initialized()


@pytest.mark.parametrize("script, flags, message", [
    ("train_pi0_flow_torch", ["--fsdp"], "--fsdp shards over the 'data' axis; it needs --dp > 1"),
    ("train_pi0_flow_torch", ["--sp", "2", "--pp", "2"],
     "--pp composes with --dp only; drop --tp/--sp/--fsdp"),
    ("train_pi0_flow_torch", ["--pp", "2", "--tp", "2"],
     "--pp composes with --dp only; drop --tp/--sp/--fsdp"),
    ("train_pi0_flow_torch", ["--dp", "2", "--batch-size", "3"], "divisible by --dp 2"),
    ("train_openvla_lora_torch", ["--fsdp"],
     "--fsdp shards over the 'data' axis; it needs --dp > 1"),
    ("train_openvla_lora_torch", ["--tp", "2", "--quantize-base", "w4a8"],
     "--tp with w4a8: the block-major int4 packing does not TP-shard; use w8a8 or tp=1"),
])
def test_jax_checks_and_messages(script, flags, message):
    with pytest.raises(SystemExit) as err:
        _cli(script).main(["--device", "cpu", *flags])
    assert str(err.value) == message or message in str(err.value)


def test_the_static_check_covers_fsdp():
    from tests.test_torch_no_jax import PORT_FILES

    assert REPO_ROOT / "blurr_tpu_torch" / "parallel" / "fsdp.py" in PORT_FILES


@pytest.mark.parametrize("scope", ["all", "action_expert", "vlm"])
def test_sharding_keeps_the_tie_and_the_scopes(scope):
    """JAX's ``test_shard_params_preserves_weight_tying_and_mask``: after
    ``shard_params`` at tp=2 (rank 0's slices; no process group is needed
    to cut them) the proprio mixture is still the action module, and each
    scope picks the slices of the one-card parameters it picked before."""
    model = PiZero(load_config(TINY), device="cpu", dtype=torch.float32)
    want = {n for n, m in SCOPES[scope](model).items() if m}
    mesh = t_mesh.Mesh(model=2)
    t_mesh.shard_params(model, mesh)
    assert model.joint["proprio"] is model.joint["action"]
    where = t_fsdp.layout(model, mesh)
    got = {where[n].name for n, m in SCOPES[scope](model).items() if m}
    assert got == want and any(".local." in n for n in SCOPES[scope](model))
