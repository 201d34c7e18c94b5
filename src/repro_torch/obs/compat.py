"""Deprecated-key shim for unified ``report()`` schemas.

The serving stack uses one report key vocabulary across the serving stack
(``p50_ms``/``p99_ms`` for latency percentiles, ``waste`` for the
padding ledger, ``compiles`` everywhere a compile counter appears).
Reports are plain dicts holding only the canonical keys; wrapping them
in :func:`renamed_keys` keeps the old spellings readable for one
deprecation cycle — reading an old key returns the canonical value and
emits a ``DeprecationWarning`` naming the replacement.

The shim is a ``dict`` subclass storing canonical keys only, so
``json.dumps``, iteration, and ``.keys()`` all see the new schema; only
``[]`` / ``get`` / ``in`` honor the aliases.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping


class ReportDict(dict):
    """dict whose deprecated key aliases still resolve (with a warning)."""

    def __init__(self, data: Mapping[str, Any],
                 aliases: Mapping[str, str]):
        super().__init__(data)
        for old, new in aliases.items():
            if new not in data:
                raise KeyError(
                    f"alias target {new!r} (for deprecated {old!r}) is "
                    f"not a report key: {sorted(data)}")
        self._aliases: Dict[str, str] = dict(aliases)

    def _resolve(self, key):
        new = self._aliases.get(key)
        if new is not None and not dict.__contains__(self, key):
            warnings.warn(
                f"report key {key!r} is deprecated; use {new!r}",
                DeprecationWarning, stacklevel=3)
            return new
        return key

    def __getitem__(self, key):
        return dict.__getitem__(self, self._resolve(key))

    def get(self, key, default=None):
        return dict.get(self, self._resolve(key), default)

    def __contains__(self, key):
        return dict.__contains__(self, key) or (
            key in self._aliases
            and dict.__contains__(self, self._aliases[key]))


def renamed_keys(data: Mapping[str, Any],
                 aliases: Mapping[str, str]) -> ReportDict:
    """Wrap a canonical report so old key spellings keep working.

    ``aliases`` maps deprecated name -> canonical name.
    """
    return ReportDict(data, aliases)
