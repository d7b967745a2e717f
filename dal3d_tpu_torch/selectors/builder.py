"""Selector construction from a config dict (port of
``dal3d_tpu/selectors/builder.py``)."""
from ..utils.registry import build_from_cfg
from .registry import SELECTORS


def build_selector(cfg, default_args=None):
    return build_from_cfg(cfg, SELECTORS, default_args)
