"""The port's ``ModuleSpec`` (``blurr_tpu_torch/utils/spec.py``) and
``get_action_accuracy`` (``utils/metric.py``) against the JAX package's on
the cases of ``tests/test_utils.py`` and seeded inputs: accuracies within
one fp32 rounding (the two means round 5/6 one ulp apart), specs and
their strings equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.utils.metric import get_action_accuracy as j_accuracy
from blurr_tpu.utils.spec import ModuleSpec as JSpec
from blurr_tpu_torch.utils.metric import get_action_accuracy as t_accuracy
from blurr_tpu_torch.utils.spec import ModuleSpec as TSpec

ULP = float(np.finfo(np.float32).eps)


def _both(gt, pred, thresholds):
    t = t_accuracy(torch.from_numpy(gt), torch.from_numpy(pred), thresholds)
    j = np.asarray(j_accuracy(jnp.asarray(gt), jnp.asarray(pred), thresholds))
    assert t.dtype == torch.float32 and t.shape == (len(thresholds),)
    np.testing.assert_allclose(t.numpy(), j, rtol=ULP, atol=0)
    return t.numpy()


def test_action_accuracy_thresholds():
    gt = np.zeros((2, 3, 4), np.float32)
    np.testing.assert_allclose(_both(gt, np.full_like(gt, 0.15), [0.1, 0.2]), [0.0, 1.0])
    pred = gt.copy()
    pred[0, 0, 0] = 0.5  # one dimension out fails the whole step
    np.testing.assert_allclose(_both(gt, pred, [0.2]), [5.0 / 6.0])


@pytest.mark.parametrize("shape", [(1, 1, 7), (4, 5, 7), (3, 2, 1)])
@pytest.mark.parametrize("thresholds", [(0.1, 0.2), (0.05,), (0.0, 0.3, 1.0)])
def test_action_accuracy_matches_jax(shape, thresholds):
    rng = np.random.RandomState(sum(shape))
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = (gt + rng.uniform(-0.25, 0.25, shape)).astype(np.float32)
    _both(gt, pred, thresholds)


def test_action_accuracy_takes_numpy():
    gt = np.zeros((1, 2, 3), np.float32)
    np.testing.assert_array_equal(t_accuracy(gt, gt).numpy(), [1.0, 1.0])


def test_module_spec_roundtrip():
    spec = TSpec.create("blurr_tpu_torch.utils.metric:get_action_accuracy")
    fn = TSpec.instantiate(spec)
    np.testing.assert_allclose(fn(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3)).numpy(), [1.0, 1.0])
    assert "get_action_accuracy" in TSpec.to_string(spec)


@pytest.mark.parametrize("target,args,kwargs", [
    ("numpy:clip", (), {"a_min": 0.0, "a_max": 1.0}),
    ("builtins:round", (2.71828,), {}),
    (np.linspace, (0.0, 1.0), {"num": 5}),
])
def test_module_spec_matches_jax(target, args, kwargs):
    t, j = TSpec.create(target, *args, **kwargs), JSpec.create(target, *args, **kwargs)
    assert dict(t) == dict(j)
    assert TSpec.to_string(t) == JSpec.to_string(j)
    call = (np.array([-1.0, 0.5, 2.0]),) if target == "numpy:clip" else ()
    if target == "builtins:round":
        assert TSpec.instantiate(t, ndigits=2)() == JSpec.instantiate(j, ndigits=2)() == 2.72
    else:
        np.testing.assert_array_equal(TSpec.instantiate(t)(*call), JSpec.instantiate(j)(*call))


def test_module_spec_instantiate_kwargs_win():
    spec = TSpec.create("numpy:full", (2,), fill_value=1.0)
    np.testing.assert_array_equal(TSpec.instantiate(spec, fill_value=3.0)(), [3.0, 3.0])


def test_module_spec_refusals():
    """Where JAX's asserts (AssertionError) the port raises ValueError."""
    for bad in ("no_colon", "a:b:c"):
        with pytest.raises(ValueError, match="fully qualified"):
            TSpec.create(bad)
        with pytest.raises(AssertionError):
            JSpec.create(bad)
    with pytest.raises(ValueError, match="Expected ModuleSpec"):
        TSpec.instantiate({"module": "numpy", "name": "clip"})
    with pytest.raises(ValueError, match="Could not import"):
        TSpec.instantiate(TSpec.create("numpy:no_such_function"))
    with pytest.raises(ValueError, match="Could not infer"):
        TSpec.create(3)
