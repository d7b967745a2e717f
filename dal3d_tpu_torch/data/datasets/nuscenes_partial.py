"""Partial-label nuScenes dataset (port of
``dal3d_tpu/data/datasets/nuscenes_partial.py``), registered as
``NUSC_PART`` / ``NuScenesPartialDataset`` in ``data/dataset_factory.py``.

The info pool is subset by an active-learning buffer before the parent's
CBGS resample:

- ``active_flag == "start"``: draw ``int(sample_ratio * len(pool))`` frame
  ids with ``random.Random(partial_seed)``, write them to ``active_buffer``
  as ``{"partial_01": ids}`` (json, ``indent=4``) and train on them. An
  existing buffer is read instead of redrawn, so a resume keeps the recorded
  set. ``faithful_start=True`` keeps the reference's quirk: a permutation
  of the first ``sample_ratio * len`` ids rather than a draw from the pool.
- any other non-empty flag: train on ``buffer[active_flag]``.
- no flag, or a buffer path that is not ``.json``: train on every frame.

``label_fraction < 1`` drops a seeded per-frame share of the GT boxes
(``np.random.RandomState(partial_seed * 100003 + idx)``; a frame keeps at
least one), a box-level budget with no reference counterpart.
"""
from __future__ import annotations

import os
import pickle
import random
from typing import Optional

import numpy as np

from ...parallel.dist import write_once
from ...utils.fileio import dump, load
from .nuscenes import NuScenesDataset


class NuScenesPartialDataset(NuScenesDataset):
    def __init__(self, *args, active_buffer: str = "", active_flag: str = "",
                 sample_ratio: float = 0.1, faithful_start: bool = False,
                 label_fraction: float = 1.0, partial_seed: int = 0, **kwargs):
        # read by load_infos, which the parent's __init__ calls
        self._active_buffer = active_buffer
        self._active_flag = active_flag
        self._sample_ratio = sample_ratio
        self._faithful_start = faithful_start
        self.label_fraction = label_fraction
        self.partial_seed = partial_seed
        super().__init__(*args, **kwargs)

    def load_infos(self, info_path: str):
        with open(info_path, "rb") as f:
            all_infos = pickle.load(f)
        if isinstance(all_infos, dict):  # a dict of splits: flatten first
            all_infos = [i for v in all_infos.values() for i in v]

        if not self._active_buffer.endswith(".json") or not self._active_flag:
            pass  # no buffer or no flag: the whole pool
        elif self._active_flag == "start":
            if os.path.exists(self._active_buffer):
                sample_ids = load(self._active_buffer)["partial_01"]
            else:
                rng = random.Random(self.partial_seed)
                num_sample = int(len(all_infos) * self._sample_ratio)
                pool = num_sample if self._faithful_start else len(all_infos)
                sample_ids = rng.sample(range(pool), num_sample)
                write_once(lambda: dump({"partial_01": sample_ids}, self._active_buffer,
                                        indent=4))
            all_infos = [all_infos[i] for i in sample_ids]
        else:
            sample_ids = load(self._active_buffer)[self._active_flag]
            all_infos = [all_infos[i] for i in sample_ids]

        self._set_infos(all_infos)

    def get_sensor_data(self, idx: int, info: Optional[dict] = None):
        if info is None:
            info = self._nusc_infos[idx]
        if "gt_boxes" in info and self.label_fraction < 1.0:
            info = dict(info)
            n = len(info["gt_names"])
            rng = np.random.RandomState(self.partial_seed * 100003 + idx)
            keep = rng.rand(n) < self.label_fraction
            if n > 0 and not keep.any():
                keep[rng.randint(n)] = True
            for k in ("gt_boxes", "gt_names", "gt_boxes_velocity", "gt_boxes_token"):
                if k in info:
                    info[k] = np.asarray(info[k])[keep]
        return super().get_sensor_data(idx, info=info)
