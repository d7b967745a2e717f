"""Executable-python experiment configs (the part of
``dal3d_tpu/utils/config.py`` that ``Config.fromfile`` uses): a config file
is a python module whose top-level, non-dunder, non-callable names become an
attribute-accessible dict; ``from _base import *`` between configs works
because the file's directory is on ``sys.path`` while it runs."""
from __future__ import annotations

import importlib.util
import os
import sys
from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: Dict[str, Any] | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class Config(ConfigDict):
    """A loaded experiment config."""

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if os.path.splitext(filename)[1] != ".py":
            raise ValueError(f"unsupported config extension: {filename}")
        module_name = "_dal3d_torch_cfg_" + os.path.splitext(os.path.basename(filename))[0]
        spec = importlib.util.spec_from_file_location(module_name, filename)
        mod = importlib.util.module_from_spec(spec)
        cfg_dir = os.path.dirname(filename)
        sys.modules[module_name] = mod
        sys.path.insert(0, cfg_dir)
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.modules.pop(module_name, None)
            if cfg_dir in sys.path:
                sys.path.remove(cfg_dir)
        return Config({k: v for k, v in mod.__dict__.items()
                       if not k.startswith("__") and not callable(v)
                       and not isinstance(v, type(sys))})
