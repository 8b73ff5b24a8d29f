"""Time K2 / K2-int8 at other split spans than the one the port ships.

The decode kernel's span (``kDecSplit`` of ``csrc/decode_attention.cuh``,
``DECODE_SPLIT`` of ``ops/flash_attention.py``) is one constant, so that a
row's bits depend on its own keys alone. To choose it, this script copies
the package once for each variant asked for into ``build/span_<variant>/``
(listed in ``.gitignore``), sets the two constants there, and runs
``kernel_timing.py decode decode_tp`` on each copy in turn, forward and
then backward over the variants (so a drift of the card shows as a
spread), each copy building its own kernels. A variant is a span, or a
span and ``/fma``: K2-int8's P.V on the FMA pipes, the route the kernel
keeps for head dims that are not a multiple of 16, instead of the tensor
cores. It prints each run's rows and, last, one JSON line of them all.
Needs a CUDA GPU:

    python3 -m livecc_tpu_torch.tools.decode_span_sweep [VARIANT ...]   # default 256 512 1024
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "livecc_tpu_torch"
KINDS = ("decode", "decode_tp")


# the tensor-core int8 P.V's guard in the header; ``/fma`` makes it false
INT8_MMA_GUARD = r"\} else if \(QUANT && kMmaQK && d % 16 == 0\) \{"


def span_copy(variant: str) -> Path:
    """``build/span_<variant>``: the package with the decode span set to the
    variant's (a multiple of 64) in the header and the wrapper, and with
    ``/fma`` K2-int8's P.V on the FMA pipes."""
    span, _, route = variant.partition("/")
    if int(span) % 64 or route not in ("", "fma"):
        raise ValueError(f"decode_span_sweep: a variant is SPAN or SPAN/fma with SPAN a "
                         f"multiple of 64, got {variant}")
    dst = ROOT / "build" / f"span_{variant.replace('/', '_')}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PACKAGE, dst / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    edits = [("csrc/decode_attention.cuh", r"constexpr int kDecSplit = \d+;",
              f"constexpr int kDecSplit = {span};"),
             ("ops/flash_attention.py", r"\nDECODE_SPLIT = \d+\n", f"\nDECODE_SPLIT = {span}\n")]
    if route:
        edits.append(("csrc/decode_attention.cuh", INT8_MMA_GUARD, "} else if (false) {"))
    for rel, pattern, repl in edits:
        path = dst / PACKAGE.name / rel
        text, n = re.subn(pattern, repl, path.read_text())
        if n != 1:
            raise RuntimeError(f"decode_span_sweep: {rel} does not hold {pattern!r} once")
        path.write_text(text)
    return dst


def time_copy(path: Path) -> dict:
    """``kernel_timing.py decode decode_tp`` on the package at ``path``."""
    env = dict(os.environ, PYTHONPATH=str(path))
    run = subprocess.run([sys.executable, str(PACKAGE / "tools" / "kernel_timing.py"), *KINDS],
                         env=env, capture_output=True, text=True, timeout=900)
    print(run.stdout, run.stderr[-4000:], sep="", flush=True)
    if run.returncode != 0:
        raise RuntimeError(f"kernel_timing.py failed on {path} ({run.returncode})")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    variants = argv or ["256", "512", "1024"]
    copies = {v: span_copy(v) for v in variants}
    runs = []
    for v in variants + variants[::-1]:
        print(f"span {v}:", flush=True)
        runs.append({"span": v, **time_copy(copies[v])})
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
