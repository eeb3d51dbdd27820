"""Logging and TensorBoard (port of ``schemanet_tpu/utils/logging_utils.py``).

Only rank 0 of ``torch.distributed`` writes TensorBoard, or the one process
when it is not initialised, as the reference's rank-0 writer
(``worker.py:176-183``). The writer is ``torch.utils.tensorboard``, which
needs the ``tensorboard`` package: where that is missing the writer still
constructs and does nothing.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

import torch


def process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 when not initialised."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def setup_logger(log_dir: Optional[str] = None, filename: Optional[str] = None,
                 level: int = logging.INFO, name: Optional[str] = None) -> logging.Logger:
    """A logger to stdout and, with ``log_dir``, to a file there (appended to
    on resume, as the reference's ``dist_engine.py:26``)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter(
        f"%(asctime)s [p{process_rank()}] %(name)s %(levelname)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        filename = filename or f"log-{time.strftime('%Y%m%d-%H%M%S')}.txt"
        path = os.path.join(log_dir, filename)
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(path)
                   for h in logger.handlers):
            fh = logging.FileHandler(path, mode="a")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class TBWriter:
    """Rank-0-only TensorBoard writer; does nothing elsewhere, without a
    ``log_dir``, or where ``tensorboard`` cannot be imported."""

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self._writer = None
        if enabled and log_dir is not None and process_rank() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_scalars(self, tag: str, values, step: int):
        if self._writer is not None:
            self._writer.add_scalars(tag, {k: float(v) for k, v in values.items()}, step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
