"""Card-speed calibration: a fixed bf16 matmul chain, timed once.

Port of ``livecc_tpu/utils/calibrate.py``. The chain's achieved TFLOP/s is
the yardstick that ``tools/layer_costs.py`` divides the training probe's
implied rate by (``vs_calibrated``), so a card held below its power limit
or its clocks shows as a lower ceiling, not as a slower layer. The products
are ``torch.matmul``: a plain large GEMM, computed in JAX outside any
Pallas kernel too.
"""

from __future__ import annotations

import time

import torch

from livecc_tpu_torch.utils.device import device_for

CAL_N = 8192
CAL_CHAIN = 8
CAL_FLOPS = CAL_CHAIN * 2 * CAL_N**3


def matmul_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``CAL_CHAIN`` products ``x = (x @ w) * (1 / n)``, then the scalar sum
    (a scalar, so reading the result moves no matrix off the card)."""
    n = w.shape[0]
    for _ in range(CAL_CHAIN):
        x = (x @ w) * (1.0 / n)
    return x.sum()


def calibrate_matmul(device="cuda", n: int = CAL_N) -> dict:
    """Returns {"wall_s", "achieved_tflops"} of the chain over ones of
    [n, n] bf16: one warm-up run, then one run timed by the host clock
    around work that ends in reading the scalar (which waits for the card).
    ``n`` exists for the CPU tests; the card runs ``CAL_N``."""
    dev = device_for(device, "calibrate_matmul")
    x = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    w = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    float(matmul_chain(x, w))                    # warm-up (cuBLAS handles, heuristics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    float(matmul_chain(x, w))
    wall = time.perf_counter() - t0
    flops = CAL_CHAIN * 2 * n**3
    return {"wall_s": round(wall, 4), "achieved_tflops": round(flops / wall / 1e12, 1)}
