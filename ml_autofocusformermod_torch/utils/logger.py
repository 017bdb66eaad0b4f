"""Per-process file + console logger (reference ``logger.py:16-41``; a copy
of the JAX package's ``utils/logger.py``)."""

from __future__ import annotations

import functools
import logging
import os
import sys

__all__ = ["create_logger"]


@functools.lru_cache()
def create_logger(output_dir: str, dist_rank: int = 0, name: str = ""):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"

    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(output_dir, f"log_rank{dist_rank}.txt"), mode="a"
        )
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)

    return logger
