"""File and console logging (counterpart of ``tpu_unet/utils/logging.py``,
the reference's format)."""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime


def setup_logging(log_dir: str, experiment_name: str, log_level=logging.INFO) -> logging.Logger:
    """A logger named ``experiment_name`` writing to stdout and to
    ``<log_dir>/<experiment_name>_<timestamp>.log``; its handlers are
    replaced on every call, and it does not propagate to the root logger."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(experiment_name)
    logger.setLevel(log_level)
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    logger.propagate = False

    file_formatter = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    console_formatter = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s", datefmt="%H:%M:%S")

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_filepath = os.path.join(log_dir, f"{experiment_name}_{timestamp}.log")
    file_handler = logging.FileHandler(log_filepath)
    file_handler.setLevel(log_level)
    file_handler.setFormatter(file_formatter)

    console_handler = logging.StreamHandler(sys.stdout)
    console_handler.setLevel(log_level)
    console_handler.setFormatter(console_formatter)

    logger.addHandler(file_handler)
    logger.addHandler(console_handler)
    logger.info(f"Logging initialized. Log file: {log_filepath}")
    return logger
