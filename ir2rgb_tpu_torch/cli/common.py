"""Shared CLI plumbing (the port's copy of ``pop_flag`` from
``ir2rgb_tpu/cli/common.py``; the rest of that module comes with the
infer CLI)."""

from __future__ import annotations

from typing import Optional


def pop_flag(argv: list, name: str) -> Optional[str]:
    """Extract a ``--name value`` pair that isn't part of the typed
    config surface (e.g. --device) from an argv list, in place."""
    if name in argv:
        i = argv.index(name)
        if i + 1 >= len(argv):
            raise SystemExit(f"{name} requires a value")
        value = argv[i + 1]
        del argv[i:i + 2]
        return value
    return None
