"""Cross-platform colored console + file logger (the port's copy of
``adas_tpu/utils/logger.py``).

Replaces the reference ``Logger`` (taskConditions.py:39-86) which relied on
``ctypes.windll`` and therefore crashed on Linux.  Colors here use ANSI
escapes, enabled only when stderr is a TTY.
"""
import logging
import sys
from typing import Optional

_RESET = "\033[0m"
_COLORS = {
    logging.DEBUG: "\033[37m",  # white
    logging.INFO: "\033[34m",  # blue
    logging.WARNING: "\033[33m",  # yellow
    logging.ERROR: "\033[31m",  # red
    logging.CRITICAL: "\033[1;31m",  # bold red
}


class _ColorFormatter(logging.Formatter):
    def __init__(self, fmt: str, datefmt: str, use_color: bool):
        super().__init__(fmt, datefmt)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


class Logger:
    """Console + optional file logger with the reference's method surface
    (``debug/info/war/error/cri`` and ``changelevel``)."""

    def __init__(
        self,
        path: Optional[str] = None,
        clevel: int = logging.DEBUG,
        flevel: int = logging.DEBUG,
    ):
        self.logger = logging.getLogger(path or "adas_tpu_torch")
        self.logger.setLevel(logging.DEBUG)
        self.logger.handlers.clear()
        self.logger.propagate = False
        self.clevel = clevel

        datefmt = "%Y-%m-%d %H:%M:%S"
        fmt = "[%(asctime)s] [%(levelname)s] %(message)s"
        use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()

        sh = logging.StreamHandler()
        sh.setFormatter(_ColorFormatter(fmt, datefmt, use_color))
        sh.setLevel(clevel)
        self.logger.addHandler(sh)

        if path is not None:
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(fmt, datefmt))
            fh.setLevel(flevel)
            self.logger.addHandler(fh)

    def changelevel(self, clevel: int) -> None:
        self.clevel = clevel
        self.logger.setLevel(clevel)
        for h in self.logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(
                h, logging.FileHandler
            ):
                h.setLevel(clevel)

    def debug(self, message) -> None:
        self.logger.debug(message)

    def info(self, message, *_args) -> None:
        self.logger.info(message)

    def war(self, message, *_args) -> None:
        self.logger.warning(message)

    def error(self, message, *_args) -> None:
        self.logger.error(message)

    def cri(self, message) -> None:
        self.logger.critical(message)
