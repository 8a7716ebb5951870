"""Structured logging (console INFO + rotating file DEBUG).

The reference ships an unused logger module and prints everywhere
(SURVEY.md §5 observability); here logging is first-class: every session
component logs through this. Domain helpers mirror the reference's
(log_move/log_noise/log_api).
"""

from __future__ import annotations

import logging
import sys

_LOGGERS = {}


def setup_logger(
    name: str = "chessvision",
    logfile: str | None = "chess_vision.log",
    console_level=logging.INFO,
    file_level=logging.DEBUG,
) -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    # stderr: tools keep stdout for their own output (bench.py's
    # one-JSON-line contract sets the convention)
    ch = logging.StreamHandler(sys.stderr)
    ch.setLevel(console_level)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if logfile:
        try:
            fh = logging.FileHandler(logfile)
            fh.setLevel(file_level)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass
    _LOGGERS[name] = logger
    return logger


def get_logger(name: str = "chessvision") -> logging.Logger:
    return _LOGGERS.get(name) or setup_logger(name)


def log_move(logger, move_uci: str, status: str):
    logger.info("MOVE %s (%s)", move_uci, status)


def log_noise(logger, state: str, detail: dict):
    logger.debug("NOISE %s %s", state, detail)


def log_api(logger, endpoint: str, ok: bool, detail: str = ""):
    logger.log(logging.INFO if ok else logging.WARNING, "API %s ok=%s %s", endpoint, ok, detail)
