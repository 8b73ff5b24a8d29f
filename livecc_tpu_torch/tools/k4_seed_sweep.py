"""Read bf16 K4's backward against its same-dtype plain reference over seeds.

    python3 -m livecc_tpu_torch.tools.k4_seed_sweep [n_seeds]    # default 10

At ``chip_smoke.py``'s timed training shape (S = 8192, segments 2900, 2700,
2300 and pad; Hq 28, Hk 4, D 128; bf16), for each seed it runs the forward
and backward kernels and prints, per gradient (dq, dk, dv), the worst share
of ``chip_smoke.py``'s limit (``|out - ref| <= 1e-2 |ref| + 2e-2 rms(ref)``)
against two bf16 plain references:

  * ``kernel``: the plain backward fed the backward kernel's own inputs, the
    forward kernel's o and lse (the reference ``phase_k4`` holds);
  * ``plain``: the plain backward fed the plain forward's o and lse.

For the worst element of each gradient under the ``kernel`` reference it
also prints the kernel's value, that reference's, and the fp32 plain
version's (fp32 inputs, nothing rounded), so a reading past the limit shows
whether the kernel or the bf16 reference sits further from the fp32 result.
Prints one JSON object per seed. Needs a CUDA GPU; it only reads, it holds
nothing.
"""

from __future__ import annotations

import json
import sys

import torch

from livecc_tpu_torch.ops.attention import prescaled
from livecc_tpu_torch.ops.train_attention import (
    train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
    train_attention_fwd_plain)

S, LENGTHS, HQ, HK, D = 8192, (2900, 2700, 2300), 28, 4, 128
RTOL, ATOL = 1e-2, 2e-2


def shares(out, ref):
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
    by_kernel = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    so, slse = train_attention_fwd_plain(qs, k, v, seg)
    by_plain = train_attention_bwd_plain(qs, k, v, seg, so, slse, do)
    del so, slse
    f32 = [x.float() for x in (qs, k, v)]
    o32, lse32 = train_attention_fwd_plain(*f32, seg)
    exact = train_attention_bwd_plain(*f32, seg, o32, lse32, do.float())
    row = {"seed": seed}
    for name, g, rk, rp, r32 in zip(("dq", "dk", "dv"), grads, by_kernel, by_plain, exact):
        sk = shares(g, rk)
        at = int(sk.argmax())
        row[name] = {"kernel": sk.max().item(), "plain": shares(g, rp).max().item(),
                     "worst": {"index": list(torch.unravel_index(torch.tensor(at), g.shape)),
                               "out": g.flatten()[at].item(), "ref": rk.flatten()[at].item(),
                               "fp32": r32.flatten()[at].item()}}
        row[name]["worst"]["index"] = [int(i) for i in row[name]["worst"]["index"]]
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k4_seed_sweep: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for seed in range(int(argv[0]) if argv else 10):
        print(json.dumps(sweep_seed(seed, dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
