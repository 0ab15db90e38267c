"""Diagnostic logging (reference macros.h:13-60 analog).

Counterpart of ``teaserpp_tpu/utils/diagnostics.py``: thin wrappers over
:mod:`logging` under the ``teaserpp_tpu_torch`` logger, gated at run time by
log level (set ``TEASERPP_TPU_DEBUG=1`` to enable debug output, mirroring the
reference's ``TEASER_DIAG_PRINT`` compile flag).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("teaserpp_tpu_torch")
if os.environ.get("TEASERPP_TPU_DEBUG"):
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())

_throttle_counters: dict = {}


def info_msg(msg: str) -> None:
    """TEASER_INFO_MSG (macros.h:18)."""
    logger.info(msg)


def debug_info_msg(msg: str) -> None:
    """TEASER_DEBUG_INFO_MSG (macros.h:30) — no-op unless debug enabled."""
    logger.debug(msg)


def debug_error_msg(msg: str) -> None:
    """TEASER_DEBUG_ERROR_MSG (macros.h:42)."""
    logger.error(msg)


def info_msg_throttle(msg: str, skip: int, key: str = "") -> None:
    """TEASER_INFO_MSG_THROTTLE (macros.h:52): emit every ``skip``-th call."""
    k = key or msg
    n = _throttle_counters.get(k, 0)
    if n % max(skip, 1) == 0:
        logger.info(msg)
    _throttle_counters[k] = n + 1
