"""The port's closed-loop evaluation path (blurr_tpu_torch/agent,
utils/geometry.py, config/core.py's registry, scripts/eval_pi0_simpler_torch.py)
against the JAX package on the CPU.

Geometry, the fake env's observations and the adapters' pre- and
postprocessing (the EDR sticky gripper over 20 chunks) are the same numpy
code, held equal exactly; pixel values are fp32 ``(x / 255 - 0.5) / 0.5`` in
both, also exact. The agents run bridge_tiny.yaml / fractal_tiny.yaml in
fp32 with 2 flow steps, the JAX agent's random weights carried over to the
port by ``load_jax_params``: the same "Number of episodes:" and "Success
rate:" lines, the same episodes, and every action chunk within 1e-5 (the
same formulas summed in another order, the fp32 noise within 4 ulps of
JAX's; < 1e-6 apart here). The stub tokenizer's ids come from Python's
``hash``, equal in both packages within one process.
"""

import logging
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from blurr_tpu.agent import fake_env as j_fake_env
from blurr_tpu.agent.env_adapter import simpler as j_simpler  # noqa: F401  (registers JAX adapters)
from blurr_tpu.config import core as j_core
from blurr_tpu.utils import geometry as j_geometry
from blurr_tpu_torch.agent import fake_env as t_fake_env
from blurr_tpu_torch.agent.env_adapter import simpler as t_simpler
from blurr_tpu_torch.config import core as t_core
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.paths import config_root, repo_root
from blurr_tpu_torch.utils import geometry as t_geometry

CHUNK_TOL = 1e-5
SUMMARY_RE = re.compile(r"^(Number of episodes: \d+|Success rate: [0-9.]+)$")
CLI = repo_root() / "scripts" / "eval_pi0_simpler_torch.py"


def _yaml(name):
    path = config_root() / "eval" / name
    return j_core.load_yaml(path), t_core.load_yaml(path)


def _adapter_cfg(name):
    j_cfg, t_cfg = _yaml(name)
    for cfg in (j_cfg, t_cfg):
        cfg["env"]["adapter"]["pretrained_model_path"] = "(stub)"
    return j_cfg["env"]["adapter"], t_cfg["env"]["adapter"]


# -- geometry, fake env, registry, adapters ----------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_geometry_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ai, aj, ak = rng.uniform(-np.pi, np.pi, 3)
    if seed == 3:
        aj = np.pi / 2  # gimbal lock
    q = rng.randn(4)
    mat = t_geometry.euler2mat(ai, aj, ak)
    cases = [
        ("euler2mat", (ai, aj, ak)), ("mat2euler", (mat,)), ("quat2mat", (q,)),
        ("mat2quat", (mat,)), ("_qmul", (q, rng.randn(4))), ("euler2quat", (ai, aj, ak)),
        ("quat2euler", (q,)), ("quat2axangle", (q,)), ("euler2axangle", (ai, aj, ak)),
    ]
    for name, args in cases:
        got, want = getattr(t_geometry, name)(*args), getattr(j_geometry, name)(*args)
        for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                        np.atleast_1d(np.asarray(want, dtype=object))):
            np.testing.assert_array_equal(np.asarray(g, np.float64),
                                          np.asarray(w, np.float64), err_msg=name)


@pytest.mark.parametrize("episode", [0, 1, 5])
def test_fake_env_matches_jax(episode):
    """Equal observations, byte for byte, over a scripted 12-step action
    sequence (a full episode)."""
    envs = [t_fake_env.make_env("fake_widowx_carrot_on_plate"),
            j_fake_env.make_env("fake_widowx_carrot_on_plate")]
    assert isinstance(envs[0], t_fake_env.FakeSimplerEnv)
    resets = [e.reset(options={"obj_init_options": {"episode_id": episode}}) for e in envs]
    assert resets[0][1] == resets[1][1]
    actions = np.random.RandomState(episode).uniform(-1, 1, (12, 7))
    obs = [r[0] for r in resets]
    for a in actions:
        np.testing.assert_array_equal(obs[0]["image"], obs[1]["image"])
        np.testing.assert_array_equal(obs[0]["agent"]["eef_pos"], obs[1]["agent"]["eef_pos"])
        out = [e.step(a) for e in envs]
        obs = [o[0] for o in out]
        assert out[0][1:4] == out[1][1:4]
    assert out[0][3]  # truncated after max_episode_steps
    assert envs[0].get_language_instruction() == envs[1].get_language_instruction()


@pytest.mark.parametrize("yaml,cls", [("bridge_tiny.yaml", "BridgeSimplerAdapter"),
                                      ("fractal_tiny.yaml", "EDRSimplerAdapter")])
def test_instantiate_resolves_the_yaml_targets(yaml, cls):
    _, t_cfg = _adapter_cfg(yaml)
    assert t_cfg["_target_"] == f"blurr_tpu.agent.env_adapter.simpler.{cls}"
    adapter = t_core.instantiate(t_cfg)
    assert type(adapter) is getattr(t_simpler, cls)
    with pytest.raises(KeyError) as mine:
        t_core.instantiate({"_target_": "a.b.NoSuchAdapter"})
    with pytest.raises(KeyError) as theirs:
        j_core.instantiate({"_target_": "a.b.NoSuchAdapter"})
    assert str(mine.value) == str(theirs.value)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("yaml", ["bridge_tiny.yaml", "fractal_tiny.yaml"])
def test_adapters_match_jax(yaml):
    """preprocess on 12 fake-env observations and postprocess on 20 action
    chunks (the EDR sticky gripper engages, holds 15 steps and releases)."""
    j_cfg, t_cfg = _adapter_cfg(yaml)
    mine, theirs = t_core.instantiate(t_cfg), j_core.instantiate(j_cfg)
    env = t_fake_env.FakeSimplerEnv()
    obs, _ = env.reset(options={"obj_init_options": {"episode_id": 2}})
    rng = np.random.RandomState(0)
    for step in range(12):
        instr = "put the carrot on the plate" if step < 6 else "open the drawer"
        got, want = mine.preprocess(env, obs, instr), theirs.preprocess(env, obs, instr)
        assert got["input_ids"].dtype == torch.int64 and got["proprios"].dtype == torch.float32
        assert got["pixel_values"].dtype == torch.float32
        for key in ("input_ids", "attention_mask", "pixel_values", "proprios"):
            np.testing.assert_array_equal(_as_np(got[key]), _as_np(want[key]), err_msg=key)
        obs = env.step(rng.uniform(-1, 1, 7))[0]
    sticky = []
    for step in range(20):
        chunk = rng.uniform(-1, 1, (4, 7))
        chunk[:, -1] = rng.choice([0.02, 0.5, 0.98], 4)
        np.testing.assert_array_equal(mine.postprocess(chunk), theirs.postprocess(chunk))
        sticky.append(getattr(mine, "sticky_action_is_on", None))
    if "fractal" in yaml:
        assert True in sticky and mine.gripper_action_repeat == theirs.gripper_action_repeat


# -- the agents --------------------------------------------------------------


def _agent_cfgs(tmp_path, yaml="bridge_tiny.yaml", **extra):
    cfgs = _yaml(yaml)
    for cfg, sub in zip(cfgs, ("jax", "port")):
        cfg["env"]["task"] = "fake_widowx_carrot_on_plate"
        cfg["env"]["adapter"]["pretrained_model_path"] = "(stub)"
        cfg.update({"n_eval_episode": 2, "n_video": 0, "seed": 42, "use_bf16": False,
                    "use_prefix_kv_cache": True, "checkpoint_path": None,
                    "num_inference_steps": 2, "log_dir": str(tmp_path / sub), **extra})
    return cfgs


def _carry_weights(port_agent, jax_agent):
    load_jax_params(port_agent.model, jax.tree.map(np.asarray, jax_agent.params))


def _record(agent, name):
    """The action chunks an agent's ``name`` method returns, in order."""
    chunks = []
    orig = getattr(agent, name)

    def wrapped(*args):
        out = orig(*args)
        chunks.append(np.array(out))
        return out

    setattr(agent, name, wrapped)
    return chunks


def _summary(caplog, package):
    lines = [r.getMessage() for r in caplog.records if r.name.startswith(package + ".")]
    return [m for m in lines if SUMMARY_RE.match(m)], [
        m for m in lines if m.startswith("Episode") and "finished" in m]


def _assert_chunks_match(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=CHUNK_TOL)


@pytest.mark.parametrize("yaml", ["bridge_tiny.yaml", "fractal_tiny.yaml"])
def test_eval_agent_matches_jax(tmp_path, caplog, yaml):
    from blurr_tpu.agent.eval_agent import EvalAgent as JEvalAgent
    from blurr_tpu_torch.agent.eval_agent import EvalAgent

    j_cfg, t_cfg = _agent_cfgs(tmp_path, yaml)
    with caplog.at_level(logging.INFO):
        theirs = JEvalAgent(j_cfg)
        mine = EvalAgent(t_cfg, device="cpu")
        _carry_weights(mine, theirs)
        got, want = _record(mine, "_fetch"), _record(theirs, "_fetch")
        rates = mine.run(), theirs.run()
    assert rates[0] == rates[1] == 0.5
    mine_lines, theirs_lines = _summary(caplog, "blurr_tpu_torch"), _summary(caplog, "blurr_tpu")
    assert mine_lines == theirs_lines
    assert mine_lines[0] == ["Number of episodes: 2", "Success rate: 0.5"]
    _assert_chunks_match(got, want)
    # 2 episodes of 12 env steps, act_steps a chunk
    assert len(got) == mine._step_idx == 24 // t_cfg["act_steps"]


def _instrument(agent):
    """The interleaving of device dispatch / fetch and env stepping (as
    tests/test_eval_e2e.py records it)."""
    events = []
    orig_dispatch, orig_fetch = agent._dispatch, agent._fetch
    agent._dispatch = lambda inputs: (events.append("dispatch"), orig_dispatch(inputs))[1]
    agent._fetch = lambda p: (events.append("fetch"), orig_fetch(p))[1]
    orig_step = agent.env.step

    def step(a):
        events.append("env_step")
        return orig_step(a)

    agent.env.step = step
    return events


def test_async_pipeline_ordering_matches_jax(tmp_path, caplog):
    """act_steps 2 with the async pipeline: the prefetch dispatch comes right
    after a chunk's first env step and its fetch only after a further one;
    the port's events are JAX's, and so are its chunks."""
    from blurr_tpu.agent.eval_agent import EvalAgent as JEvalAgent
    from blurr_tpu_torch.agent.eval_agent import EvalAgent

    j_cfg, t_cfg = _agent_cfgs(tmp_path, act_steps=2, async_pipeline=True,
                               n_eval_episode=1)
    theirs = JEvalAgent(j_cfg)
    mine = EvalAgent(t_cfg, device="cpu")
    _carry_weights(mine, theirs)
    events, j_events = _instrument(mine), _instrument(theirs)
    got, want = _record(mine, "_fetch"), _record(theirs, "_fetch")
    with caplog.at_level(logging.INFO):
        mine.run()
        theirs.run()
    assert events == j_events
    assert events[0:2] == ["dispatch", "fetch"]
    for i in range(2, len(events)):
        if events[i] != "dispatch":
            continue
        assert events[i - 1] == "env_step", events[: i + 1]
        tail = events[i + 1:]
        if "fetch" in tail:
            k = tail.index("fetch")
            assert "env_step" in tail[:k], events[i: i + k + 2]
    assert "Async pipeline: residual fetch wait" in caplog.text
    _assert_chunks_match(got, want)


def test_batched_eval_matches_jax(tmp_path, caplog):
    """3 envs in lockstep finishing 4 episodes (slots reused, one slot idle
    at the end): the same summary, episodes and [3, 4, 7] chunks as JAX's."""
    from blurr_tpu.agent.batched_eval import BatchedEvalAgent as JBatched
    from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent

    j_cfg, t_cfg = _agent_cfgs(tmp_path, act_steps=4, batch_envs=3, n_eval_episode=4)
    with caplog.at_level(logging.INFO):
        theirs = JBatched(j_cfg)
        mine = BatchedEvalAgent(t_cfg, device="cpu")
        _carry_weights(mine, theirs)
        got, want = _record(mine, "_batched_infer"), _record(theirs, "_batched_infer")
        rates = mine.run(), theirs.run()
    assert rates[0] == rates[1]
    mine_lines, theirs_lines = _summary(caplog, "blurr_tpu_torch"), _summary(caplog, "blurr_tpu")
    assert mine_lines == theirs_lines and mine_lines[0][0] == "Number of episodes: 4"
    assert "Batched eval: 3 envs in lockstep" in caplog.text
    _assert_chunks_match(got, want)
    assert got[0].shape == (3, 4, 7)


# -- the CLI -----------------------------------------------------------------


def test_cli_runs_on_the_cpu_and_the_collector_parses_it(tmp_path):
    sys.path.insert(0, str(repo_root() / "scripts"))
    try:
        from collect_bridge_eval_results import collect
    finally:
        sys.path.remove(str(repo_root() / "scripts"))
    run_dir = tmp_path / "blurr_42" / "fake_widowx_carrot_on_plate_2026-01-01_00-00-00"
    proc = subprocess.run(
        [sys.executable, str(CLI), "--task", "fake_widowx_carrot_on_plate",
         "--checkpoint", "random", "--config", "config/eval/bridge_tiny.yaml",
         "--preset", "blurr", "--n-eval-episode", "2", "--device", "cpu",
         "--log-dir", str(run_dir)],
        cwd=repo_root(), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    log = (run_dir / "run.log").read_text()
    assert "Number of episodes: 2" in log and "Success rate: 0.5" in log
    assert "use_torch_compile is set and has no effect" in log
    rows = collect(tmp_path)
    assert [(r["model"], r["task"], r["success_rate"], r["episodes"]) for r in rows] == [
        ("blurr_42", "fake_widowx_carrot_on_plate", 0.5, 2)]


def test_cli_defaults_and_record_dataset(tmp_path, monkeypatch):
    """The JAX CLI's flags and defaults, plus --device (default cuda);
    --record-dataset reaches the agent's config as JAX's CLI sets it, and
    with --batch-envs > 1 exits with JAX's message."""
    sys.path.insert(0, str(repo_root() / "scripts"))
    try:
        import eval_pi0_simpler
        import eval_pi0_simpler_torch
    finally:
        sys.path.remove(str(repo_root() / "scripts"))
    from blurr_tpu_torch.agent import eval_agent

    argv = ["--task", "t", "--checkpoint", "random"]
    mine = vars(eval_pi0_simpler_torch.parse_args(argv))
    monkeypatch.setattr(sys, "argv", ["eval_pi0_simpler.py", *argv])
    theirs = vars(eval_pi0_simpler.parse_args())
    assert mine.pop("device") == "cuda"
    assert mine == theirs
    seen = []

    class Agent:
        def __init__(self, cfg, device=None):
            seen.append((cfg, device))

        def run(self):
            return 0.0

    monkeypatch.setattr(eval_agent, "EvalAgent", Agent)
    record = ["--record-dataset", str(tmp_path / "d"), "--log-dir", str(tmp_path / "log")]
    eval_pi0_simpler_torch.main([*argv, *record, "--device", "cpu"])
    assert seen[0][0]["record_dataset_dir"] == str(tmp_path / "d") and seen[0][1] == "cpu"
    exits = []
    for cli, args in ((eval_pi0_simpler_torch.main, [*argv, *record, "--batch-envs", "2"]),
                      (eval_pi0_simpler.main, None)):
        monkeypatch.setattr(sys, "argv", ["eval_pi0_simpler.py", *argv, *record,
                                          "--batch-envs", "2"])
        with pytest.raises(SystemExit) as exit_:
            cli(args) if args else cli()
        exits.append(str(exit_.value.code))
    assert exits[0] == exits[1] and "serial-agent feature" in exits[0]
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("mode", ["serial", "async"])
def test_record_dataset_matches_jax(tmp_path, mode):
    """--record-dataset on the fake env: the port writes the shard files of
    JAX's agent, the four input keys byte for byte, the actions within
    CHUNK_TOL; one example per fetched chunk (the async prefetch records the
    inputs its chunk was dispatched from; a chunk dispatched as the episode
    ends is never fetched, and not recorded). The env is action-coupled, so
    the port's env steps JAX's chunks: the port's own, ~1e-6 away, would
    move the later observations by an ulp."""
    from blurr_tpu.agent.eval_agent import EvalAgent as JEvalAgent
    from blurr_tpu_torch.agent.eval_agent import EvalAgent
    from blurr_tpu_torch.data import ShardedDataset

    extra = dict(act_steps=2, async_pipeline=True, n_eval_episode=1) if mode == "async" else {}
    j_cfg, t_cfg = _agent_cfgs(tmp_path, **extra)
    j_cfg["record_dataset_dir"] = str(tmp_path / "jax_rec")
    t_cfg["record_dataset_dir"] = str(tmp_path / "port_rec")
    theirs = JEvalAgent(j_cfg)
    mine = EvalAgent(t_cfg, device="cpu")
    _carry_weights(mine, theirs)
    fetched, want_chunks = _record(mine, "_fetch"), _record(theirs, "_fetch")
    theirs.run()
    chunks = iter(want_chunks)
    postprocess = mine.env_adapter.postprocess
    mine.env_adapter.postprocess = lambda actions: postprocess(next(chunks))
    mine.run()
    files = lambda d: sorted(p.name for p in (tmp_path / d).iterdir())
    assert files("port_rec") == files("jax_rec")
    got, want = ShardedDataset(tmp_path / "port_rec"), ShardedDataset(tmp_path / "jax_rec")
    assert got.keys == want.keys and got.num_examples == want.num_examples == len(fetched)
    idx = np.arange(want.num_examples)
    a, b = got.gather_batch(idx), want.gather_batch(idx)
    for key in ("input_ids", "attention_mask", "pixel_values", "proprios"):
        assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    np.testing.assert_allclose(a["actions"], b["actions"], rtol=0, atol=CHUNK_TOL)
