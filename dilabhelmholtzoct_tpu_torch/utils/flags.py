"""Strict boolean flag parsing for the CLIs (copy of
``dilabhelmholtzoct_tpu/utils/flags.py``): unknown tokens are an error,
never a silent True ('--shuffle f' must not shuffle)."""

from __future__ import annotations

import argparse

_TRUE = ("true", "t", "yes", "y", "on", "1")
_FALSE = ("false", "f", "no", "n", "off", "0", "")


def str2bool(v) -> bool:
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")
