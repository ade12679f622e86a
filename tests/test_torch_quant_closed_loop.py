"""The port's closed-loop quantization experiment
(``blurr_tpu_torch/experiments/quant_closed_loop.py``) on the CPU, at
bridge_tiny's dims in place of the shipped pool64 presets: the variants
and controls JAX's ``experiments/quant_closed_loop.py`` names, its report
lines, and the GPTQ variant rolled through its control's episode.
"""

import importlib
import sys

import numpy as np
import pytest

from blurr_tpu_torch.experiments import quant_closed_loop as t_qcl


def _jax_experiment():
    sys.path.insert(0, "experiments")
    try:
        return importlib.import_module("experiments.quant_closed_loop")
    finally:
        sys.path.remove("experiments")


def test_tables_and_report_match_jax(capsys):
    j_qcl = _jax_experiment()
    assert t_qcl.VARIANTS == j_qcl.VARIANTS and t_qcl.CONTROL == j_qcl.CONTROL
    for yaml_name, quant in t_qcl.VARIANTS.values():
        mine, theirs = t_qcl.variant_cfg(yaml_name, quant), j_qcl.variant_cfg(yaml_name, quant)
        assert mine == theirs
    rng = np.random.RandomState(0)
    ref = (rng.rand(24, 8), rng.rand(4, 7))
    cur = (rng.rand(20, 8), rng.rand(4, 7))
    line = t_qcl._report("pool64_w4a8 vs pool64_bf16", ref, cur)
    j_qcl._report("pool64_w4a8 vs pool64_bf16", ref, cur)
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [line, line]
    with pytest.raises(SystemExit, match="unknown variant"):
        t_qcl.main(["pool64_w5a8", "--device", "cpu"])


def test_gptq_variant_rolls_at_tiny_dims(monkeypatch, capsys):
    tiny = {tag: ("bridge_tiny.yaml", quant if quant != "gptq" else "w4a8_gptq")
            for tag, (yaml_name, quant) in t_qcl.VARIANTS.items() if tag.startswith("pool64")}
    monkeypatch.setattr(t_qcl, "VARIANTS", {**t_qcl.VARIANTS, **tiny})
    real = t_qcl.variant_cfg

    def chunks_of_four(yaml_name, quant):
        cfg = real(yaml_name, quant)
        cfg["act_steps"] = 4
        return cfg

    monkeypatch.setattr(t_qcl, "variant_cfg", chunks_of_four)
    monkeypatch.setattr(t_qcl, "EPISODES", 1)
    out = t_qcl.main(["pool64_w4a8_gptq", "--device", "cpu"])
    assert set(out) == {"pool64_bf16", "pool64_w4a8_gptq", "report"}  # and its control
    assert [line.split(":")[0].strip() for line in out["report"]] == [
        "pool64_w4a8_gptq vs pool64_bf16"]
    rolled = [out[tag] for tag in ("pool64_bf16", "pool64_w4a8_gptq")]
    assert {len(traj) for traj, _ in rolled} == {12}
    assert all(np.isfinite(chunk).all() for _, chunk in rolled)
    assert "pool64: base params initialized" in capsys.readouterr().out
