from .registry import SELECTORS
from .builder import build_selector
from .base_selector import BaseSelector
from .geometry_selectors import (
    RandomSelector, SpatialSelector, EuSpatialSelector, TemporalSelector,
    SpatialTemporalSelector,
)
from .model_selectors import (
    FeatureSelector, EntropySelector, BadgeSelector, UWESelector, PPALSelector,
    CaldSelector,
)
from .combo_selectors import SpatialFeatureSelector, SpatialTemporalFeatureSelector

__all__ = [
    "SELECTORS", "build_selector", "BaseSelector",
    "RandomSelector", "SpatialSelector", "EuSpatialSelector", "TemporalSelector",
    "SpatialTemporalSelector", "FeatureSelector", "EntropySelector",
    "BadgeSelector", "UWESelector", "PPALSelector", "CaldSelector",
    "SpatialFeatureSelector", "SpatialTemporalFeatureSelector",
]
