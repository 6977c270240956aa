"""Logging setup for elektronn3_tpu_torch (the JAX package's
``logger.py``; reference elektronn3/logger.py:17-66): one package logger
with a colored console handler at INFO and a DEBUG log of the run: the
Trainer sends the DEBUG records to its run directory
(:func:`change_log_file_to`), the first run's file starting with the
records from before it (kept in memory, the last 10,000: importing the
package opens no file). A later run's log starts where the earlier
run's ends; the earlier file stays in its directory (the JAX package
moves it into the later run's)."""

import collections
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
_FILE_FORMAT = "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if os.isatty(2):
            return f"{_ANSI.get(record.levelno, '')}{msg}{_RESET}"
        return msg


class _EarlyRecords(logging.Handler):
    """The DEBUG records from before a run directory exists, the last
    ``capacity``."""

    def __init__(self, capacity: int = 10000):
        super().__init__(logging.DEBUG)
        self.records = collections.deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def _file_handler(path: str) -> logging.FileHandler:
    fh = logging.FileHandler(path)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(_FILE_FORMAT))
    return fh


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
    logger.addHandler(_EarlyRecords())
    return logger


def change_log_file_to(new_path: str) -> None:
    """Write the DEBUG records to ``new_path`` from now on, after the
    records kept from before the first run (reference
    trainer.py:66-89)."""
    logger = logging.getLogger(_LOGGER_NAME)
    fh = _file_handler(new_path)
    for h in list(logger.handlers):
        if isinstance(h, _EarlyRecords):
            for record in h.records:
                fh.handle(record)
        elif not isinstance(h, logging.FileHandler):
            continue
        logger.removeHandler(h)
        h.close()
    logger.addHandler(fh)


logger = logger_setup()
