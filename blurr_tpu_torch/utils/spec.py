"""A serializable callable: the module it lives in, its name, and default
arguments (the Octo-style ``ModuleSpec``).

The port's own copy of ``blurr_tpu/utils/spec.py``: ``create`` from a
callable or a ``"pkg.module:Name"`` string, ``instantiate`` to a
``functools.partial`` (keyword arguments given there win over the spec's),
``to_string`` for logs.
"""

from __future__ import annotations

import importlib
from functools import partial
from typing import Any, Callable, Dict, Tuple, TypedDict, Union


class ModuleSpec(TypedDict):
    """JSON-serializable representation of a callable and its default
    args / kwargs."""

    module: str
    name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]

    @staticmethod
    def create(callable_or_full_name: Union[str, Callable], *args, **kwargs) -> "ModuleSpec":  # type: ignore[misc]
        if isinstance(callable_or_full_name, str):
            if callable_or_full_name.count(":") != 1:
                raise ValueError("Expected fully qualified import string 'pkg.module:Name', "
                                 f"got {callable_or_full_name!r}")
            module, name = callable_or_full_name.split(":")
        else:
            module, name = _infer_full_name(callable_or_full_name)
        return ModuleSpec(module=module, name=name, args=args, kwargs=kwargs)

    @staticmethod
    def instantiate(spec: "ModuleSpec", **kwargs):  # type: ignore[misc]
        if set(spec.keys()) != {"module", "name", "args", "kwargs"}:
            raise ValueError(f"Expected ModuleSpec, got {spec}")
        fn = _import_from_string(spec["module"], spec["name"])
        return partial(fn, *spec["args"], **{**spec["kwargs"], **kwargs})

    @staticmethod
    def to_string(spec: "ModuleSpec") -> str:  # type: ignore[misc]
        args = list(map(repr, spec["args"]))
        args += [f"{k}={v!r}" for k, v in spec["kwargs"].items()]
        return f"{spec['module']}:{spec['name']}({', '.join(args)})"


def _infer_full_name(obj) -> Tuple[str, str]:
    if hasattr(obj, "__module__") and hasattr(obj, "__name__"):
        return obj.__module__, obj.__name__
    raise ValueError(f"Could not infer identifier for {obj}; pass a fully qualified string.")


def _import_from_string(module_string: str, name: str):
    try:
        return getattr(importlib.import_module(module_string), name)
    except Exception as exc:
        raise ValueError(f"Could not import {module_string}:{name}") from exc
