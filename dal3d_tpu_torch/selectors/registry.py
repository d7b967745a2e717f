"""Selector registry (port of ``dal3d_tpu/selectors/registry.py``)."""
from ..utils.registry import Registry

SELECTORS = Registry("selector")
