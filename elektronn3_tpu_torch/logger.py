"""Logging setup for elektronn3_tpu_torch: one package logger with a
console handler at INFO (the JAX package's ``logger.py``; the per-run
log file of training comes with the trainer)."""

import logging
import os

_LOGGER_NAME = "elektronn3_tpu_torch"

_ANSI = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if os.isatty(2):
            return f"{_ANSI.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def logger_setup() -> logging.Logger:
    """Create (or return) the package logger."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(_ColorFormatter(
        "[%(asctime)s] [%(levelname)s] %(message)s", datefmt="%H:%M:%S"))
    logger.addHandler(sh)
    return logger


logger = logger_setup()
