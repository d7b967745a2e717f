"""Dataset factory (port of ``dal3d_tpu/data/dataset_factory.py``): a config's
``dataset_type``, as a short factory key ("NUSC", "NUSC_PART", "KITTI",
"LYFT") or a class name, -> the port's dataset class; unknown names raise
``KeyError`` as in JAX."""
from __future__ import annotations


def get_dataset_cls(name: str):
    from .datasets.kitti import KittiDataset
    from .datasets.lyft import LyftDataset
    from .datasets.nuscenes import NuScenesDataset
    from .datasets.nuscenes_partial import NuScenesPartialDataset

    table = {
        "NUSC": NuScenesDataset,
        "NuScenesDataset": NuScenesDataset,
        "NUSC_PART": NuScenesPartialDataset,
        "NuScenesPartialDataset": NuScenesPartialDataset,
        "KITTI": KittiDataset,
        "KittiDataset": KittiDataset,
        "LYFT": LyftDataset,
        "LyftDataset": LyftDataset,
    }
    try:
        return table[name]
    except KeyError:
        raise KeyError(f"unknown dataset_type {name!r}; known: {sorted(table)}")


def build_dataset(cfg, dataset_type: str | None = None, **common):
    """A dataset from a config dict section; ``common`` gives the
    framework-side kwargs (tasks, max_points, voxelize_host, ...), which win
    over the raw config values they were derived from."""
    cfg = dict(cfg)
    name = dataset_type or cfg.pop("type", "NuScenesDataset")
    cfg.pop("type", None)
    cls = get_dataset_cls(name)
    cfg.pop("ann_file", None)  # reference configs alias info_path
    return cls(**{**cfg, **common})
