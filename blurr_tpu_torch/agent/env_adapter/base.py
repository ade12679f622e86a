"""(De)normalization math shared by env adapters.

The port's own copy of ``blurr_tpu/agent/env_adapter/base.py``, unchanged,
including the asymmetric eps placement: the forward bound-normalization
divides by (max - min + eps), but the inverse multiplies by the UN-padded
(max - min), so a round trip is off by the eps ratio. Trained policies
absorbed this convention; do not "fix" it.
"""

import numpy as np

_EPS = 1e-8


def hoist_field_stats(stats: dict, fields=("action", "proprio")) -> dict:
    """Per-field {stat_name: float64 array} from a dataset-statistics dict
    (bridge_statistics.json schema) — the ONE hoisting helper shared by the
    env adapters and the training transform, so the two preprocessing paths
    cannot drift. Accepts JSON lists and numpy arrays; scalar metadata
    (num_transitions etc.) passes through the filter."""
    out = {}
    for field in fields:
        out[field] = {
            k: np.asarray(v, np.float64)
            for k, v in stats[field].items()
            if isinstance(v, (list, np.ndarray))
        }
        if not out[field]:
            raise ValueError(
                f"dataset statistics field {field!r} has no array-valued "
                f"stats (keys: {list(stats[field])})"
            )
    return out


def bound_normalize(data, lo, hi, clip_min=-1.0, clip_max=1.0, eps=_EPS):
    """Map [lo, hi] -> [-1, 1] (p01/p99 bounds), clipped to the clip range."""
    span = hi - lo + eps
    return np.clip((data - lo) * (2.0 / span) - 1.0, clip_min, clip_max)


def bound_denormalize(data, lo, hi, clip_min=-1.0, clip_max=1.0, eps=_EPS):
    """Inverse of :func:`bound_normalize` (note: no eps on the span here —
    reference convention, see module docstring)."""
    frac = (data - clip_min) / (clip_max - clip_min)
    return frac * (hi - lo) + lo


def gaussian_normalize(data, mean, std, eps=_EPS):
    return (data - mean) / (std + eps)


def gaussian_denormalize(data, mean, std, eps=_EPS):
    return data * (std + eps) + mean


class BaseEnvAdapter:
    """Method-style access used by the Simpler/EDR adapters."""

    def normalize_bound(self, data, data_min, data_max, clip_min=-1,
                        clip_max=1, eps=_EPS):
        return bound_normalize(data, data_min, data_max, clip_min, clip_max, eps)

    def denormalize_bound(self, data, data_min, data_max, clip_min=-1,
                          clip_max=1, eps=_EPS):
        return bound_denormalize(data, data_min, data_max, clip_min, clip_max, eps)

    def normalize_gaussian(self, data, mean, std, eps=_EPS):
        return gaussian_normalize(data, mean, std, eps)

    def denormalize_gaussian(self, data, mean, std, eps=_EPS):
        return gaussian_denormalize(data, mean, std, eps)
