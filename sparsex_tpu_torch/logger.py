"""Leveled logger with console/file/null sinks.

The port's own copy of ``sparsex_tpu/logger.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with the reference logging layer (``include/sparsex/internals/logger/
Logger.hpp:33-56``, ``src/internals/logger/Logger.cpp``): five levels
(Error, Warning, Info, Verbose, Debug), three sinks (Null, Console, File),
independently bindable per level.  Defaults: Error + Warning -> console
(stderr), everything else off.
"""

from __future__ import annotations

import enum
import sys
import threading
from typing import Callable, Dict, Optional, TextIO


class Level(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    VERBOSE = 3
    DEBUG = 4


_PREFIX = {
    Level.ERROR: "[ERROR]",
    Level.WARNING: "[WARNING]",
    Level.INFO: "[INFO]",
    Level.VERBOSE: "[VERBOSE]",
    Level.DEBUG: "[DEBUG]",
}

Sink = Callable[[str], None]


def null_sink(_msg: str) -> None:
    pass


def console_sink(msg: str) -> None:
    print(msg, file=sys.stderr)


class _FileSink:
    def __init__(self, path: str):
        self._fp: TextIO = open(path, "a")
        self._lock = threading.Lock()

    def __call__(self, msg: str) -> None:
        with self._lock:
            self._fp.write(msg + "\n")
            self._fp.flush()


class LoggingHandler:
    """Singleton binding each level to a sink."""

    _instance: Optional["LoggingHandler"] = None

    def __init__(self):
        self.sinks: Dict[Level, Sink] = {
            Level.ERROR: console_sink,
            Level.WARNING: console_sink,
            Level.INFO: null_sink,
            Level.VERBOSE: null_sink,
            Level.DEBUG: null_sink,
        }

    @classmethod
    def instance(cls) -> "LoggingHandler":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def set_sink(self, level: Level, sink: Sink) -> None:
        self.sinks[Level(level)] = sink

    # --- parity helpers mirroring spx_log_*_console / _file / disable_* ---
    def all_to_console(self) -> None:
        for lvl in Level:
            self.sinks[lvl] = console_sink

    def all_to_file(self, path: str) -> None:
        sink = _FileSink(path)
        for lvl in Level:
            self.sinks[lvl] = sink

    def level_to_console(self, level: Level) -> None:
        self.sinks[Level(level)] = console_sink

    def level_to_file(self, level: Level, path: str) -> None:
        self.sinks[Level(level)] = _FileSink(path)

    def disable_all(self) -> None:
        for lvl in Level:
            self.sinks[lvl] = null_sink

    def disable_level(self, level: Level) -> None:
        self.sinks[Level(level)] = null_sink

    def log(self, level: Level, fmt: str, *args) -> None:
        sink = self.sinks[Level(level)]
        if sink is null_sink:
            return
        msg = fmt % args if args else fmt
        sink(f"{_PREFIX[Level(level)]} {msg}")


def log_error(fmt: str, *args) -> None:
    LoggingHandler.instance().log(Level.ERROR, fmt, *args)


def log_warning(fmt: str, *args) -> None:
    LoggingHandler.instance().log(Level.WARNING, fmt, *args)


def log_info(fmt: str, *args) -> None:
    LoggingHandler.instance().log(Level.INFO, fmt, *args)


def log_verbose(fmt: str, *args) -> None:
    LoggingHandler.instance().log(Level.VERBOSE, fmt, *args)


def log_debug(fmt: str, *args) -> None:
    LoggingHandler.instance().log(Level.DEBUG, fmt, *args)
