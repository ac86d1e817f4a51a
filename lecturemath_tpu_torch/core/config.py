"""Flat ``KEY = value`` configuration files, compatible with the reference
AccessMath format (reference: AM_CommonTools/configuration/configuration.py).

Format rules (shared with the reference):
  * one ``KEY = value`` per line, keys are upper-cased on load
  * ``#`` starts a comment line; blank lines ignored
  * values are parsed with ``ast.literal_eval`` and fall back to raw strings

Conscious fix vs the reference: the reference silently drops any line whose
value itself contains ``=`` (configuration.py:110-113). We split on the FIRST
``=`` so such values load correctly; round-trips through ``save`` preserve
the reference's on-disk shape.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, Optional


class Config:
    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        self._order: list[str] = []
        if values:
            for key, val in values.items():
                self.set(key, val)

    # ------------------------------------------------------------------ I/O

    @classmethod
    def from_file(cls, path: str) -> "Config":
        config = cls()
        with open(path, "r") as f:
            for raw_line in f:
                line = raw_line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    continue
                key, _, raw_value = line.partition("=")
                config.set(key.strip().upper(), _parse_value(raw_value.strip()))
        return config

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for key in self._order:
                f.write(f"{key} = {self._values[key]}\n")

    # -------------------------------------------------------------- access

    def set(self, key: str, value: Any) -> None:
        key = key.upper()
        if key not in self._values:
            self._order.append(key)
        self._values[key] = value

    def contains(self, key: str) -> bool:
        return key.upper() in self._values

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key.upper(), default)

    def get_str(self, key: str, default: Optional[str] = None) -> Optional[str]:
        value = self.get(key, default)
        return None if value is None else str(value)

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        value = self.get(key, default)
        return None if value is None else int(value)

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        value = self.get(key, default)
        return None if value is None else float(value)

    def get_bool(self, key: str, default: Optional[bool] = None) -> Optional[bool]:
        # The reference stores booleans as 0/1 or True/False literals; accept both.
        value = self.get(key, default)
        if value is None:
            return None
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes")
        return bool(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __repr__(self) -> str:
        return f"Config({len(self._values)} keys)"


def _parse_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_cli_overrides(argv: list[str]) -> Dict[str, Any]:
    """Parse ``-key value [value...]`` style optional CLI parameters.

    Mirrors the reference's MiscHelper.optional_parameters
    (AccessMath/util/misc_helper.py:18-41): a token starting with ``-`` opens a
    new key; following tokens are its values. A single value stays scalar, and
    multiple values become a list.
    """
    params: Dict[str, Any] = {}
    key = None
    for token in argv:
        if token.startswith("-") and len(token) > 1 and not _is_number(token):
            key = token[1:]
            params[key] = True  # flag-style default until a value arrives
        elif key is not None:
            if params[key] is True:
                params[key] = token
            elif isinstance(params[key], list):
                params[key].append(token)
            else:
                params[key] = [params[key], token]
    return params


def _is_number(token: str) -> bool:
    try:
        float(token)
        return True
    except ValueError:
        return False
