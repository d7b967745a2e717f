"""Root logger setup (own copy of ``dal3d_tpu/utils/log.py``). Rank 0 of a
process group, or a process without one, logs to the stream and to the
file, which is attached also when an earlier call in the same process set
the logger up without it or with another file; the other ranks log errors
only, to the stream."""
from __future__ import annotations

import logging
import os

from ..parallel.dist import get_dist_info


def get_root_logger(log_file: str | None = None, log_level: int | str = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("dal3d")
    if isinstance(log_level, str):
        log_level = getattr(logging, log_level.upper())
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.setLevel(log_level)
        logger.propagate = False
    if get_dist_info()[0] != 0:
        logger.setLevel(logging.ERROR)
        return logger
    if log_file is not None:
        path = os.path.abspath(log_file)
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename == path:
                return logger
            logger.removeHandler(h)  # a run logs to its own work_dir
            h.close()
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
