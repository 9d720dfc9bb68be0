"""Structured leveled logging (a copy of cometbft_tpu/utils/log.py;
reference: libs/log — logfmt TMLogger).

Keeps the reference's shape: ``logger.info(msg, **kv)``, ``with_fields`` to
bind module context, per-module level filtering, and logfmt or JSON output.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from typing import Any, TextIO

LEVELS = {"debug": 0, "info": 1, "error": 2, "none": 3}


def _logfmt_value(v: Any) -> str:
    if isinstance(v, bytes):
        v = v.hex().upper()
    s = str(v)
    if not s or any(c in ' "=' for c in s) or any(ord(c) < 0x20 for c in s):
        return json.dumps(s)
    return s


class Logger:
    """A leveled, key-value logger bound to a set of context fields."""

    def __init__(
        self,
        sink: TextIO | None = None,
        level: str = "info",
        fmt: str = "logfmt",
        fields: dict[str, Any] | None = None,
        module_levels: dict[str, str] | None = None,
        lock: threading.Lock | None = None,
    ):
        self._sink = sink if sink is not None else sys.stderr
        self._level_name = level
        self._level = LEVELS[level]
        self._fmt = fmt
        self._fields = dict(fields or {})
        self._module_levels = module_levels or {}
        self._lock = lock or threading.Lock()

    def with_fields(self, **fields: Any) -> "Logger":
        merged = dict(self._fields)
        merged.update(fields)
        return Logger(
            sink=self._sink,
            level=self._level_name,
            fmt=self._fmt,
            fields=merged,
            module_levels=self._module_levels,
            lock=self._lock,
        )

    def _enabled(self, level: int) -> bool:
        mod = self._fields.get("module")
        if mod is not None and mod in self._module_levels:
            return level >= LEVELS[self._module_levels[mod]]
        return level >= self._level

    def _emit(self, level_name: str, msg: str, kv: dict[str, Any]) -> None:
        record: dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "level": level_name,
            **self._fields,
            "msg": msg,
            **kv,
        }
        if self._fmt == "json":
            line = json.dumps(record, default=str)
        else:
            buf = io.StringIO()
            for k, v in record.items():
                buf.write(f"{k}={_logfmt_value(v)} ")
            line = buf.getvalue().rstrip()
        with self._lock:
            self._sink.write(line + "\n")

    # ``args`` format ``msg`` as ``logging`` does, so a service's
    # start/stop lines (utils/service.py) can go to this logger too
    def debug(self, msg: str, *args: Any, **kv: Any) -> None:
        if self._enabled(0):
            self._emit("debug", msg % args if args else msg, kv)

    def info(self, msg: str, *args: Any, **kv: Any) -> None:
        if self._enabled(1):
            self._emit("info", msg % args if args else msg, kv)

    def error(self, msg: str, *args: Any, **kv: Any) -> None:
        if self._enabled(2):
            self._emit("error", msg % args if args else msg, kv)


class NopLogger(Logger):
    def __init__(self) -> None:
        super().__init__(sink=io.StringIO(), level="none")

    def _enabled(self, level: int) -> bool:  # noqa: ARG002
        return False


_default: Logger | None = None
_default_mtx = threading.Lock()


def default_logger() -> Logger:
    global _default
    with _default_mtx:
        if _default is None:
            _default = Logger()
        return _default


def set_default_logger(logger: Logger) -> None:
    global _default
    with _default_mtx:
        _default = logger


def parse_log_level(spec: str, default: str = "info") -> tuple[str, dict[str, str]]:
    """Parse ``"p2p:debug,consensus:info,*:error"`` style level specs
    (reference: libs/log/filter.go semantics via config ``log_level``)."""
    base = default
    per_module: dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            mod, lvl = item.split(":", 1)
            if lvl not in LEVELS:
                raise ValueError(f"unknown log level {lvl!r}")
            if mod == "*":
                base = lvl
            else:
                per_module[mod] = lvl
        else:
            if item not in LEVELS:
                raise ValueError(f"unknown log level {item!r}")
            base = item
    return base, per_module
