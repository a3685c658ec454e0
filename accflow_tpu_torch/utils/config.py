"""Experiment configs (configs/*.yml) with attribute access, the port's copy
of accflow_tpu/utils/config.py (reference utils/util.py:11-61).

The port reads YAML itself, so it needs no YAML package: it reads the
subset that configs/*.yml use and raises ValueError on anything else.

- one `key: value` pair per line, at the left margin (no nesting);
- values: plain strings, decimal ints, floats in YAML 1.1's
  resolver form (a dot, and a signed exponent if any: `1.0e-5`), any
  number tagged `!!float` (`!!float 1.2e-4`), `true` / `false`, `~` or
  `null`, and inline lists of such scalars (`[256, 256]`);
- `#` comments, on a line of their own or after a value.

Anything that YAML 1.1 reads otherwise than as written is refused rather
than guessed: an untagged `1e-4` (a string to YAML 1.1), `yes` / `no` /
`on` / `off` (booleans to YAML 1.1), and quotes, indentation, block
lists, flow mappings, anchors, block scalars, other tags and duplicate
keys.
"""

from __future__ import annotations

import re
from typing import Any

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_NUMBERISH = re.compile(r"^[-+]?[0-9.][0-9._eE+-]*$")
_AMBIGUOUS = {"yes", "no", "on", "off", "y", "n"}
_RESERVED = set("&*!|>{}%@`-")


class AttrDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at the start, or after blanks)."""
    m = re.search(r"(^|\s)#", line)
    return line[: m.start()] if m else line


def _scalar(text: str, where: str):
    text = text.strip()
    if text.startswith("!!float "):
        body = text[len("!!float "):].strip()
        try:
            return float(body)
        except ValueError:
            raise ValueError(f"{where}: !!float of {body!r}") from None
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    if text.lower() in _AMBIGUOUS:
        raise ValueError(f"{where}: {text!r} is a boolean to YAML 1.1; write true or false")
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _NUMBERISH.match(text):
        raise ValueError(f"{where}: {text!r} is not a YAML 1.1 number; tag it !!float")
    if text[0] in _RESERVED or text[0] in "'\"[]" or ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: unsupported YAML: {text!r}")
    return text


def _value(text: str, where: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated list: {text!r}")
        body = text[1:-1].strip()
        if "[" in body or "]" in body:
            raise ValueError(f"{where}: nested lists are not read: {text!r}")
        return [_scalar(item, where) for item in body.split(",")] if body else []
    return _scalar(text, where)


def loads(text: str) -> dict:
    """The mapping of a config's text (the subset in the module docstring)."""
    out: dict = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"line {lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented (nested) YAML is not read: {raw!r}")
        if line.startswith(("---", "...")):
            raise ValueError(f"{where}: YAML documents are not read: {raw!r}")
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"{where}: expected `key: value`, got {raw!r}")
        key, val = m.group(1), m.group(2)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        out[key] = _value(val or "", where)
    return out


def parse_options(path: str) -> AttrDict:
    with open(path) as f:
        return AttrDict.wrap(loads(f.read()))
