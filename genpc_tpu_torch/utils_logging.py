"""File + stream logger (counterpart of genpc_tpu/utils_logging.py;
reference: utils/logger_util.py:6-47).

Same behavior minus the hard-coded Beijing-time formatter: timestamps are
local time with explicit UTC offset.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional


def get_logger(name: str = "genpc_tpu_torch",
               log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S" + time.strftime("%z"))
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
