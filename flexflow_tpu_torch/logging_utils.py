"""Leveled category loggers (copy of ``flexflow_tpu/logging_utils.py``).

Usage::

    from flexflow_tpu_torch.logging_utils import get_logger
    log = get_logger("serve")
    log.debug("dispatched %d rows", n)

Verbosity comes from ``FF_LOG`` (e.g. ``FF_LOG=serve=debug`` or
``FF_LOG=debug`` for everything), as in the JAX package.
"""
from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, Set

_CONFIGURED = False
_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}
#: bad FF_LOG level tokens already warned about (warn once per token)
_WARNED_LEVELS: Set[str] = set()


def _resolve_level(token: str) -> int:
    lvl = token.strip().lower()
    if lvl in _LEVELS:
        return _LEVELS[lvl]
    if lvl not in _WARNED_LEVELS:
        _WARNED_LEVELS.add(lvl)
        warnings.warn(
            f"FF_LOG: unknown level {token.strip()!r} — falling back to "
            f"INFO (accepted levels: {', '.join(sorted(_LEVELS))})",
            stacklevel=4,
        )
    return logging.INFO


def _parse_ff_log() -> Dict[str, int]:
    spec = os.environ.get("FF_LOG", "")
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            cat, lvl = part.split("=", 1)
            out[cat.strip()] = _resolve_level(lvl)
        else:
            out["*"] = _resolve_level(part)
    return out


def get_logger(category: str) -> logging.Logger:
    """Category logger ``flexflow_tpu_torch.<category>`` honoring FF_LOG."""
    global _CONFIGURED
    logger = logging.getLogger(f"flexflow_tpu_torch.{category}")
    if not _CONFIGURED:
        root = logging.getLogger("flexflow_tpu_torch")
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(
                logging.Formatter("[%(name)s %(levelname).1s] %(message)s")
            )
            root.addHandler(h)
        root.setLevel(logging.WARNING)
        _CONFIGURED = True
    levels = _parse_ff_log()
    if category in levels:
        logger.setLevel(levels[category])
    elif "*" in levels:
        logger.setLevel(levels["*"])
    return logger
