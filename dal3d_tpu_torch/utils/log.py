"""Root logger setup (own copy of ``dal3d_tpu/utils/log.py``; single
process, so the file handler is always attached)."""
from __future__ import annotations

import logging


def get_root_logger(log_file: str | None = None, log_level: int | str = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("dal3d")
    if isinstance(log_level, str):
        log_level = getattr(logging, log_level.upper())
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(log_level)
    logger.propagate = False
    return logger
