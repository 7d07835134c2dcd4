"""Minimal loguru-style logger on std logging (the port's copy of
custom_d_fine_tpu/utils/logging.py; loguru is not a dependency).

Provides the subset the framework uses: logger.info/warning/error and
logger.add(file) for the per-run train_log.txt sink (reference
train.py:135-139).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path


class _Logger:
    def __init__(self):
        self._log = logging.getLogger("custom_d_fine_tpu_torch")
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                                             datefmt="%H:%M:%S"))
            self._log.addHandler(h)
        self._file_handlers = {}

    def add(self, path, level: str = "INFO", **kwargs):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        h = logging.FileHandler(path)
        h.setLevel(getattr(logging, level))
        h.setFormatter(logging.Formatter("%(message)s"))
        self._log.addHandler(h)
        self._file_handlers[str(path)] = h
        return h

    def remove(self, handler=None):
        if handler is not None:
            self._log.removeHandler(handler)

    def info(self, msg, *a):
        self._log.info(msg if not a else str(msg).format(*a))

    def warning(self, msg, *a):
        self._log.warning(msg if not a else str(msg).format(*a))

    def error(self, msg, *a):
        self._log.error(msg if not a else str(msg).format(*a))

    def debug(self, msg, *a):
        self._log.debug(msg if not a else str(msg).format(*a))


logger = _Logger()
