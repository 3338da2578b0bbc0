"""Logging setup for the port's entry points."""

import logging
import sys

__all__ = ["get_logger", "set_logger"]

_FORMAT = "%(levelname)s | %(name)s | %(message)s"


def get_logger(name):
    return logging.getLogger(name)


def set_logger(debug=False):
    level = logging.DEBUG if debug else logging.INFO
    root = logging.getLogger()
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
