"""A copy of ``livecc_tpu/utils/reporting.py``.

Report capture: run a report function and tee its stdout to a file
(reference evaluation/utils.py:3-10 save_function_print)."""

from __future__ import annotations

import contextlib
import io
from typing import Callable


def save_function_print(fn: Callable, path: str, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    text = buf.getvalue()
    with open(path, "w") as f:
        f.write(text)
    print(text, end="")
    return result
