"""Config loading of the port: its own copy of ``blurr_tpu/config/core.py``.

The subset the port needs of that minimal OmegaConf-style config system,
unchanged: ``Config`` (a dict with attribute access), ``deep_merge``,
``${a.b.c}`` and ``${oc.env:VAR[,default]}`` interpolation, and
``load_yaml`` with its ``defaults:`` list for single-parent inheritance
(bridge_pool64_steps2.yaml inherits bridge.yaml), and the ``_target_``
registry (``register``, ``instantiate``) through which the eval agent builds
its env adapter. A test holds ``load_yaml`` to the JAX package's on every
bundled eval config.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict

import yaml

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_INNER_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """A dict with attribute access and OmegaConf-flavoured helpers."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):  # Config included — rewrap recursively
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def deep_merge(base: dict, override: dict) -> Config:
    """Merge ``override`` into ``base`` recursively (override wins)."""
    out = Config()
    for k, v in base.items():
        out[k] = copy.deepcopy(v)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return Config.wrap(out)


def _lookup(root: Any, dotted: str) -> Any:
    cur = root
    for part in dotted.split("."):
        if isinstance(cur, dict):
            cur = cur[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(dotted)
    return cur


def _resolve_token(token: str, root: Any) -> Any:
    token = token.strip()
    if token.startswith("oc.env:"):
        spec = token[len("oc.env:") :]
        if "," in spec:
            var, default = spec.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        val = os.environ.get(spec.strip())
        if val is None:
            raise KeyError(f"environment variable {spec!r} not set")
        return val
    if token.startswith("now:"):
        import time

        fmt = token[len("now:") :]
        return time.strftime(fmt)
    return _lookup(root, token)


def resolve_interpolations(node: Any, root: Any) -> Any:
    """Recursively resolve ``${...}`` strings against ``root``."""
    if isinstance(node, dict):
        return Config({k: resolve_interpolations(v, root) for k, v in node.items()})
    if isinstance(node, list):
        return [resolve_interpolations(v, root) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.match(node)
        if full:
            val = _resolve_token(full.group(1), root)
            return resolve_interpolations(val, root)

        def sub(m):
            # recurse like the full-match path: a looked-up value may itself
            # interpolate (OmegaConf semantics), e.g. "${base}/run_${seed}"
            # with base: ${oc.env:...} must not leak literal ${...} text
            return str(
                resolve_interpolations(_resolve_token(m.group(1), root), root)
            )

        if _INTERP_INNER_RE.search(node):
            return _INTERP_INNER_RE.sub(sub, node)
        return node
    return node


def load_yaml(path: str | Path, resolve: bool = True) -> Config:
    """Load a YAML config; honours a ``defaults:`` parent list.

    ``defaults: [parent, _self_]`` loads ``parent.yaml`` from the same
    directory and merges this file on top (matching the OmegaConf/Hydra
    semantics the reference configs rely on).
    """
    path = Path(path)
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    raw.pop("hydra", None)

    defaults = raw.pop("defaults", None)
    cfg = Config.wrap(raw)
    if defaults:
        merged = Config()
        for item in defaults:
            if item == "_self_":
                merged = deep_merge(merged, cfg)
            else:
                parent = load_yaml(path.parent / f"{item}.yaml", resolve=False)
                merged = deep_merge(merged, parent)
        if "_self_" not in defaults:
            merged = deep_merge(merged, cfg)
        cfg = merged
    if resolve:
        cfg = resolve_interpolations(cfg, cfg)
    return cfg


# ---------------------------------------------------------------------------
# Registry replacing hydra.utils.instantiate
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def instantiate(cfg: dict, **kwargs) -> Any:
    """Instantiate the registered target named by ``cfg._target_``.

    The key is the last dotted part of ``_target_``, so the bundled YAMLs'
    targets (``blurr_tpu.agent.env_adapter.simpler.BridgeSimplerAdapter``)
    resolve to the port's classes of that name once their module is
    imported.
    """
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    key = target.rsplit(".", 1)[-1]
    if key not in _REGISTRY:
        raise KeyError(f"No registered target for {target!r} (key {key!r})")
    ctor = _REGISTRY[key]
    cfg.update(kwargs)
    return ctor(**cfg)
