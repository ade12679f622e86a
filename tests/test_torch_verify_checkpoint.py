"""The port's checkpoint checker, ``scripts/verify_checkpoint_torch.py``,
against the JAX package's ``scripts/verify_checkpoint.py`` on files each
test writes: a clean ``bridge_tiny`` Pi-0 ``.pt``
(``tests/test_checkpoint_bridge.synth_torch_state``), one with a tensor of
the wrong shape, one with a key missing, one with an extra key, one with a
layer missing, a tiny PaliGemma directory (clean, and without its final
norm) and a tiny OpenVLA snapshot held against OpenVLA-7B's widths. The
port counts a layer's keys as one leaf, as the JAX package stacks them, so
both report the same counts in the same sections; the port names a leaf by
the file's keys, JAX by its tree's path. The exit codes are equal; where a
key the JAX tree needs is absent, JAX's script stops on the exception
(exit 1 from the interpreter) and the port's reports it and returns 1.
``--parity`` exits 2 on both (the reference tree is absent).
"""

import importlib
import json
import re
import sys

import numpy as np
import pytest
import torch

from blurr_tpu_torch.presets import load_config

TINY = "config/eval/bridge_tiny.yaml"


def _jax(monkeypatch, capsys, argv):
    """JAX's CLI in-process: (exit code as a process would give it, stdout)."""
    cli = importlib.import_module("scripts.verify_checkpoint")
    monkeypatch.setattr(sys, "argv", ["verify_checkpoint.py", *argv])
    try:
        rc = cli.main() or 0
    except SystemExit as e:
        rc = e.code or 0
    except Exception:  # an uncaught exception exits the interpreter with 1
        rc = 1
    return rc, capsys.readouterr().out


def _port(capsys, argv):
    cli = importlib.import_module("scripts.verify_checkpoint_torch")
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _both(monkeypatch, capsys, argv):
    return _jax(monkeypatch, capsys, argv), _port(capsys, argv)


def _counts(out):
    """The report's counts: the leaf line, each section's count, the total."""
    return re.findall(r"^(?:expected leaves: \d+  loaded leaves: \d+|[A-Z ]+ \(\d+\):"
                      r"|\d+ problems found\.|OK: .*)$", out, re.M)


@pytest.fixture(scope="module")
def pi0_state():
    from tests.test_checkpoint_bridge import synth_torch_state

    return synth_torch_state(load_config(TINY))


def _broken(state, case):
    state = dict(state)
    if case == "wrong_shape":
        state["action_decoder.weight"] = torch.zeros(3, 3)
    elif case == "key_missing":
        del state["action_decoder.bias"]
    elif case == "extra_key":
        state["extra_head.weight"] = torch.zeros(2, 2)
    elif case == "layer_missing":
        del state["joint_model.mixtures.vlm.layers.0.mlp.up_proj.weight"]
    elif case == "ragged_layer":
        state["joint_model.mixtures.action.layers.1.mlp.down_proj.weight"] = torch.zeros(4, 4)
    return state


CASES = {"clean": 0, "wrong_shape": 1, "key_missing": 1, "extra_key": 0, "layer_missing": 1,
         "ragged_layer": 1}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pi0_reports_match_jax(tmp_path, monkeypatch, capsys, pi0_state, case):
    path = tmp_path / f"{case}.pt"
    torch.save({"model": _broken(pi0_state, case)}, path)
    argv = ["--checkpoint", str(path), "--kind", "pi0", "--config", TINY]
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, argv)
    assert trc == jrc == CASES[case]
    n = 62 if case == "key_missing" else 63
    assert tout.startswith(f"expected leaves: 63  loaded leaves: {n}")
    if case in ("key_missing", "layer_missing", "ragged_layer"):
        # JAX stops on the exception; the port names the problem
        assert jout == ""
        assert _counts(tout)[1:] == [
            "MISSING (1):" if case == "key_missing" else "SHAPE MISMATCH (1):",
            "1 problems found."]
    else:
        assert _counts(tout) == _counts(jout)
    if case == "layer_missing":
        assert ("joint_model.mixtures.vlm.layers.*.mlp.up_proj.weight: expected "
                "(3, 512, 128), got 2 layers 1..2 of shapes [(512, 128)]") in tout
    if case == "wrong_shape":
        assert "SHAPE MISMATCH (1):\n  action_decoder/w: expected (64, 7), got (3, 3)" in jout
        assert "SHAPE MISMATCH (1):\n  action_decoder.weight: expected (7, 64), got (3, 3)" in tout
    if CASES[case] == 0:
        assert "OK: checkpoint matches" in tout


@pytest.mark.parametrize("kind", ["pi0", "paligemma"])
def test_parity_exits_2(tmp_path, monkeypatch, capsys, pi0_state, kind):
    if kind == "pi0":
        path = tmp_path / "ok.pt"
        torch.save({"model": pi0_state}, path)
    else:
        path = _paligemma_dir(tmp_path)
    argv = ["--checkpoint", str(path), "--kind", kind, "--config", TINY, "--parity"]
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys, argv)
    assert trc == jrc == 2
    assert tout.splitlines()[-1] == jout.splitlines()[-1]


def _paligemma_dir(tmp_path, drop=()):
    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration
    from blurr_tpu_torch.models.pi0.checkpoint import paligemma_state_dict, save_safetensors
    from scripts.demo_paligemma_text_torch import TINY_CONFIG

    model = PaliGemmaForConditionalGeneration(PaliGemmaConfig(**TINY_CONFIG), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    state = paligemma_state_dict(model.embed_tokens, model.vision_tower,
                                 model.multi_modal_projector, model.vlm)
    path = tmp_path / "paligemma"
    path.mkdir()
    save_safetensors({k: v for k, v in state.items() if k not in drop},
                     str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(TINY_CONFIG))
    return path


@pytest.mark.parametrize("drop,rc", [((), 0), (("language_model.model.norm.weight",), 1)])
def test_paligemma_reports_match_jax(tmp_path, monkeypatch, capsys, drop, rc):
    path = _paligemma_dir(tmp_path, drop)
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys,
                                     ["--checkpoint", str(path), "--kind", "paligemma"])
    assert trc == jrc == rc
    assert _counts(tout) == _counts(jout)
    if drop:
        assert "MISSING (1):\n  joint/vlm/final_norm/scale" in jout
        assert "MISSING (1):\n  language_model.model.norm.weight" in tout


def test_openvla_tiny_snapshot_against_7b_matches_jax(tmp_path, monkeypatch, capsys):
    """A tiny snapshot held against OpenVLA-7B's widths (the kind's
    expected model): every leaf's shape differs, in the same report."""
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec
    from tests.test_torch_openvla_checkpoint import write_snapshot

    write_snapshot(tmp_path, OpenVLASpec.tiny())
    (jrc, jout), (trc, tout) = _both(monkeypatch, capsys,
                                     ["--checkpoint", str(tmp_path), "--kind", "openvla"])
    assert trc == jrc == 1
    assert _counts(tout) == _counts(jout)
    n = int(tout.split()[2])
    assert f"SHAPE MISMATCH ({n}):" in tout and n > 40


def test_openvla_meta_tree_is_jax_init_tree():
    """The port's expected OpenVLA-7B leaves, the loader's key map on the
    meta device grouped over the layers, are JAX's init_params leaves: as
    many, and as many elements in all."""
    import jax

    from blurr_tpu.models.openvla.model import OpenVLA as JOpenVLA
    from blurr_tpu.models.openvla.model import OpenVLASpec as JSpec
    from blurr_tpu_torch.models.openvla.checkpoint import openvla_hf_state_dict
    from blurr_tpu_torch.models.openvla.model import OpenVLA, OpenVLASpec
    from scripts.verify_checkpoint_torch import leaves

    want = jax.tree.leaves(jax.eval_shape(lambda: JOpenVLA(JSpec()).init_params(
        jax.random.PRNGKey(0))))
    model = OpenVLA(OpenVLASpec(), device="meta", dtype=torch.float32)
    got = leaves({k: tuple(v.shape) for k, v in openvla_hf_state_dict(model).items()})
    assert len(got) == len(want)
    assert sum(int(np.prod(s)) for s in got.values()) == sum(int(np.prod(x.shape)) for x in want)
    assert got["language_model.model.layers.*.mlp.gate_proj.weight"] == (32, 11008, 4096)
