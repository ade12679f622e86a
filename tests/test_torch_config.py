"""The port's own config loading (blurr_tpu_torch.config.core, paths,
presets.load_config) against the JAX package's blurr_tpu.config.core."""

import copy
import os

import pytest

from blurr_tpu import paths as j_paths
from blurr_tpu.config import core as j_core
from blurr_tpu_torch import paths as t_paths
from blurr_tpu_torch.config import core as t_core
from blurr_tpu_torch.presets import load_config

EVAL_CONFIGS = sorted((j_paths.config_root() / "eval").glob("*.yaml"))


def test_the_port_finds_the_bundled_configs():
    assert t_paths.config_root() == j_paths.config_root()
    assert t_paths.repo_root() == j_paths.repo_root()
    assert len(EVAL_CONFIGS) >= 10


@pytest.mark.parametrize("path", EVAL_CONFIGS, ids=lambda p: p.name)
def test_load_yaml_gives_jax_dict(path, monkeypatch):
    """Every bundled eval config, defaults: chain and interpolations
    resolved, environment interpolation both unset and set."""
    for var in ("VLA_LOG_DIR", "TRANSFORMERS_CACHE"):
        monkeypatch.delenv(var, raising=False)
    assert t_core.load_yaml(path).to_dict() == j_core.load_yaml(path).to_dict()
    monkeypatch.setenv("VLA_LOG_DIR", "/logs")
    monkeypatch.setenv("TRANSFORMERS_CACHE", "/weights")
    port = t_core.load_yaml(path)
    assert port.to_dict() == j_core.load_yaml(path).to_dict()
    assert t_core.load_yaml(path, resolve=False).to_dict() == (
        j_core.load_yaml(path, resolve=False).to_dict())
    assert isinstance(port, t_core.Config)


def test_config_helpers_behave_as_jax(tmp_path):
    parent = tmp_path / "base.yaml"
    parent.write_text("a: {b: 1, c: [1, 2]}\nname: base\nref: ${a.b}\n")
    child = tmp_path / "child.yaml"
    child.write_text("defaults: [base, _self_]\na: {c: [3]}\nname: x_${ref}\n")
    port, jax_cfg = t_core.load_yaml(child), j_core.load_yaml(child)
    assert port.to_dict() == jax_cfg.to_dict() == {
        "a": {"b": 1, "c": [3]}, "name": "x_1", "ref": 1}
    assert port.a.b == 1
    clone = copy.deepcopy(port)
    clone.a.b = 5
    assert port.a.b == 1 and isinstance(clone, t_core.Config)
    merged = t_core.deep_merge({"a": {"b": 1}}, {"a": {"c": 2}})
    assert merged == j_core.deep_merge({"a": {"b": 1}}, {"a": {"c": 2}})
    with pytest.raises(AttributeError):
        port.missing


def test_load_config_resolves_relative_paths_from_anywhere(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config("config/eval/bridge_tiny.yaml")
    want = j_core.load_yaml(j_paths.config_root() / "eval" / "bridge_tiny.yaml")
    assert cfg.to_dict() == want.to_dict()
    assert os.getcwd() == str(tmp_path)
