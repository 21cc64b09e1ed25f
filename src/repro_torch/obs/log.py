"""Structured logging for the launchers.

``launch/train.py`` and ``launch/serve.py`` used bare ``print(f"[train]
...")`` calls — fine for a human at a terminal, useless for anything that
wants to scrape step records.  This module gives each launcher a named
logger with two renderings of the SAME call:

* human (default): ``[train] step 3 | loss 1.234`` — byte-identical to the
  old prints, so default output does not change;
* JSON (``--log-json``): one ``json.dumps`` object per line with
  ``logger``/``msg`` plus any structured fields, machine-parseable.

The mode is a process-wide switch (:func:`set_json`) because it models one
thing — what kind of consumer is attached to stdout — not a per-logger
preference.
"""
from __future__ import annotations

import json
import sys

__all__ = ["Logger", "get_logger", "set_json", "json_enabled"]

_JSON = False
_LOGGERS: dict[str, "Logger"] = {}


def set_json(on: bool) -> None:
    """Switch ALL loggers to JSON-lines (or back).  Wired to ``--log-json``
    in the launchers."""
    global _JSON
    _JSON = bool(on)


def json_enabled() -> bool:
    return _JSON


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def info(self, msg: str, **fields) -> None:
        if _JSON:
            rec = {"logger": self.name, "msg": msg}
            rec.update(fields)
            sys.stdout.write(json.dumps(rec, sort_keys=True) + "\n")
        else:
            # Human format matches the historical `print(f"[name] ...")`
            # exactly; structured fields are assumed to already be baked
            # into msg by the caller when they matter to a human.
            sys.stdout.write(f"[{self.name}] {msg}\n")


def get_logger(name: str) -> Logger:
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = Logger(name)
        _LOGGERS[name] = lg
    return lg
