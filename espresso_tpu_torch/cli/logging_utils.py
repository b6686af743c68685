"""Shared CLI logging setup.

The port's own copy of ``espresso_tpu/cli/logging_utils.py``: one stdout
handler for the CLIs, replacing the handlers other libraries installed at
import but keeping a test harness's (pytest caplog).
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def setup_logging(level: int = logging.INFO, stream=None) -> None:
    """Install the CLI stdout handler, removing import-time interlopers
    (orbax/absl) but keeping test-harness handlers (pytest caplog)."""
    root = logging.getLogger()
    for h in list(root.handlers):
        if "pytest" not in type(h).__module__:
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.setLevel(level)
