"""String-keyed class registry + config-driven construction (own copy of
``dal3d_tpu/utils/registry.py``): wires selectors from executable-python
configs, ``dict(type=..., **kwargs)``."""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, type] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, type]:
        return self._module_dict

    def get(self, key: str) -> Optional[type]:
        return self._module_dict.get(key, None)

    def register_module(self, cls=None, *, name: Optional[str] = None, force: bool = False):
        def _register(cls):
            if not inspect.isclass(cls) and not inspect.isfunction(cls):
                raise TypeError(f"module must be a class or function, got {type(cls)}")
            module_name = name or cls.__name__
            if not force and module_name in self._module_dict:
                raise KeyError(f"{module_name} already registered in {self._name}")
            self._module_dict[module_name] = cls
            return cls

        if cls is None:
            return _register
        return _register(cls)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, default_args: Optional[dict] = None):
    """Instantiate a registered class from a ``dict(type=..., **kwargs)`` config."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
