"""Read bf16 K4's backward against its gradient check over seeds.

    python3 -m livecc_tpu_torch.tools.k4_seed_sweep [n_seeds]    # default 10

At ``chip_smoke.py``'s timed training shape (S = 8192, segments 2900, 2700,
2300 and pad; Hq 28, Hk 4, D 128; bf16), for each seed it runs the forward
and backward kernels and prints, per gradient (dq, dk, dv), the worst share
of two limits, each for the kernel and for ``phase_k4``'s planted fault
(``kernel_check.dropped_tile``: query tile 44 of q head 3 without key tile
22):

  * ``new``: ``kernel_check.grad_close``, the check ``phase_k4`` holds:
    ``|out - ref32| <= 1e-2 |ref32| + GRAD_SPREAD * max over the row
    |ref - ref32| + GRAD_FLOOR * rms(ref32)``, against the fp32 plain
    version (fp32 inputs, nothing rounded) with the bf16 plain version on
    the kernels' o and lse setting the rounding allowed;
  * ``old``: the check it replaced, ``|out - ref| <= 1e-2 |ref| + 2e-2
    rms(ref)`` against that bf16 plain version.

For the kernel's worst element under the old limit it also prints the
kernel's value, the bf16 reference's and the fp32 plain version's. Prints
one JSON object per seed and a last line with the worst kernel share and
the least fault share of each limit over the seeds. Needs a CUDA GPU; it
only reads, it holds nothing.
"""

from __future__ import annotations

import json
import sys

import torch

from livecc_tpu_torch.ops.attention import prescaled
from livecc_tpu_torch.ops.train_attention import (
    train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
    train_attention_fwd_plain)
from livecc_tpu_torch.tools import kernel_check

S, LENGTHS, HQ, HK, D = 8192, (2900, 2700, 2300), 28, 4, 128
RTOL, ATOL = 1e-2, 2e-2
QT, KT, HEAD = LENGTHS[0] // 64 - 1, (LENGTHS[0] // 64 - 1) // 2, 3   # phase_k4's fault


def old_shares(out, ref):
    """Elementwise |out - ref| / (RTOL |ref| + ATOL rms(ref))."""
    out, ref = out.float(), ref.float()
    return (out - ref).abs() / (RTOL * ref.abs() + ATOL * ref.square().mean().sqrt())


def sweep_seed(seed: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(100 + seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    qs, k, v, do = prescaled(randn(1, S, HQ, D)), randn(1, S, HK, D), randn(1, S, HK, D), \
        randn(1, S, HQ, D)
    seg = torch.zeros((1, S), dtype=torch.int32)
    at = 0
    for i, n in enumerate(LENGTHS):
        seg[0, at:at + n] = i + 1
        at += n
    seg = seg.to(dev)
    o, lse = train_attention_fwd(qs, k, v, seg)
    grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
    ref = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    fault = kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, ref, QT, KT, HEAD)[2:]
    f32 = [x.float() for x in (qs, k, v)]
    exact = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                      do.float())
    row = {"seed": seed}
    for name, g, rb, bad, r32 in zip(("dq", "dk", "dv"), grads, ref, fault, exact):
        so = old_shares(g, rb)
        row[name] = {
            "new": kernel_check.grad_close(g, rb, r32),
            "new_fault": kernel_check.grad_close(bad, rb, r32),
            "old": so.max().item(),
            "old_fault": old_shares(g, bad).max().item()}
        at = int(so.argmax())
        row[name]["worst_old"] = {"out": g.flatten()[at].item(), "ref": rb.flatten()[at].item(),
                                  "fp32": r32.flatten()[at].item()}
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k4_seed_sweep: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for seed in range(int(argv[0]) if argv else 10):
        rows.append(sweep_seed(seed, dev))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    summary = {g: {key: (max if key in ("new", "old") else min)(r[g][key] for r in rows)
                   for key in ("new", "new_fault", "old", "old_fault")}
               for g in ("dq", "dk", "dv")}
    print(json.dumps({"worst kernel share, least fault share": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
