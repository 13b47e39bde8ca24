"""Shared CLI helpers.

A copy of ``art_tpu/cli/_common.py``, unchanged.
"""

from __future__ import annotations

import re

_NUM = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)")


def strtod(s: str) -> float:
    """C strtod prefix semantics: longest valid leading number, else 0.0
    (the reference parses every numeric option this way, so a bare or
    malformed argument means 0, never a crash)."""
    m = _NUM.match(s or "")
    return float(m.group(0)) if m else 0.0


def strtol(s: str) -> int:
    """C strtol/atoi prefix semantics: leading integer, else 0."""
    m = re.match(r"[+-]?\d+", s or "")
    return int(m.group(0)) if m else 0


def num_suffix(s: str) -> float:
    """Parse a number with an optional k/K kilo suffix (reference
    art.c option parsing convention: strtod, then a trailing k)."""
    v = strtod(s)
    m = _NUM.match(s or "")
    rest = s[m.end():] if m else (s or "")
    if rest[:1] in ("k", "K"):
        v *= 1000.0
    return v
