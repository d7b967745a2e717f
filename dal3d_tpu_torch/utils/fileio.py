"""Format-dispatched load/dump for json / yaml / pkl (own copy of
``dal3d_tpu/utils/fileio.py``).

The active-learning loop's file contracts (buffer JSON, infos .pkl) go through
these helpers, so the port writes the same bytes as the JAX package.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lstrip(".").lower()


def load(path: str, file_format: str | None = None) -> Any:
    fmt = file_format or _ext(path)
    if fmt == "json":
        with open(path, "r") as f:
            return json.load(f)
    if fmt in ("yml", "yaml"):
        import yaml

        with open(path, "r") as f:
            return yaml.safe_load(f)
    if fmt in ("pkl", "pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unsupported format: {fmt} ({path})")


def dump(obj: Any, path: str, file_format: str | None = None, **kwargs) -> None:
    """Serialize ``obj`` to ``path``; extra kwargs go to the backend writer
    (mmcv-style surface, e.g. ``dump(buf, "b.json", indent=4)``)."""
    fmt = file_format or _ext(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    if fmt == "json":
        with open(path, "w") as f:
            json.dump(obj, f, **kwargs)
    elif fmt in ("yml", "yaml"):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(obj, f, **kwargs)
    elif fmt in ("pkl", "pickle"):
        with open(path, "wb") as f:
            pickle.dump(obj, f, **kwargs)
    else:
        raise ValueError(f"unsupported format: {fmt} ({path})")
