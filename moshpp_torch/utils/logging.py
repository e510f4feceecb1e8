"""Session logging (port of `moshpp_tpu/utils/logging.py`, which replaces
the reference's loguru setup, mosh_head.py:75-83): stdlib logging with
per-session file sinks and a session/basename/subject-prefixed format."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER_NAME = "moshpp_torch"


class _StdoutHandler(logging.StreamHandler):
    """A stream handler on whatever `sys.stdout` is when a record is
    written (a caller may swap it, as a test's output capture does)."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _):
        pass


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = _StdoutHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_log_file(path: Optional[str], prefix: str = "") -> None:
    """Attach (or clear) a file sink; `prefix` is embedded in each record the
    way the reference embeds session/basename/subject."""
    logger = get_logger()
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fh = logging.FileHandler(path)
        fmt = (prefix + " -- " if prefix else "") + "%(module)s:%(funcName)s:%(lineno)d -- %(message)s"
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
