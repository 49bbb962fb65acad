"""YAML configs and the ``target:``-style component registry.

Port of ``vface_tpu/utils/config.py``: :func:`load_yaml` (PyYAML's
``safe_load``; the JAX package takes OmegaConf first where it is installed,
which reads the same plain YAML to the same containers), the short-name
registry (:func:`register`, :func:`build`) and the reference's reflective
constructor (:func:`get_obj_from_str`, :func:`instantiate_from_config`: a
dotted ``target`` and its ``params`` keyword arguments).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    """A decorator that registers its function or class under ``name`` for :func:`build`."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build(name: str, **kwargs):
    """The component registered under ``name``, called with ``kwargs``; KeyError naming the known ones."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown component {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def get_obj_from_str(string: str, reload: bool = False):
    """The object at a dotted path ``pkg.mod.Name`` (its module reloaded first with ``reload``)."""
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: Dict[str, Any]):
    """``{"target": "pkg.mod.Class", "params": {...}}`` -> ``Class(**params)``;
    KeyError without a ``target``."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    return get_obj_from_str(config["target"])(**config.get("params", {}))


def load_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
