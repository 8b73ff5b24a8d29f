"""The training front door and K4's non-causal form on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card (which
has no jax, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_train_cli_gpu.py -q

  * ``python -m livecc_tpu_torch.train.cli`` on the tiny config in fp32
    over a seek-indexed corpus (frames through an in-memory loader): the
    card's losses within 1e-4 relative of ``--device cpu``'s;
  * K4's non-causal form (``causal=False``, splash's ``FullMask``) against
    its plain version: o and lse by ``kernel_check.close``, bf16 gradients
    by ``kernel_check.grad_close`` against the fp32 plain version, fp32
    outputs within 1e-4; the planted fault ``kernel_check.causal_walk``
    (the causal form's walk and mask) must fail the same checks, and two
    bf16 launches must be bit-equal.
"""

import json

import numpy as np
import pytest
import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.attention import prescaled
from livecc_tpu_torch.ops.train_attention import (
    train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
    train_attention_fwd_plain)
from livecc_tpu_torch.tools import kernel_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_train_cli_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class SeededVideo:
    """``VideoReader``'s API over seeded frames, served at any size by
    nearest-neighbour index maps (the CPU tests' ``SeededClips``; this file
    imports nothing of JAX)."""

    def __init__(self, path):
        n, fps, hw, seed = {"a.mp4": (24, 4.0, (56, 84), 1), "b.mp4": (20, 5.0, (42, 70), 3)}[
            path.rsplit("/", 1)[-1]]
        self.frames = np.random.RandomState(seed).randint(0, 256, (n, *hw, 3), dtype=np.uint8)
        self.avg_fps, self.frame_size = fps, hw
        self.pts_seconds = np.arange(n) / fps

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        h, w = out_hw or self.frame_size
        rows = np.arange(h) * self.frame_size[0] // h
        cols = np.arange(w) * self.frame_size[1] // w
        return self.frames[np.asarray(indices)][:, rows][:, :, cols]


def test_tiny_cli_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """``train.cli.main`` on the tiny random init (fp32) over a two-row
    streaming corpus, 2 steps of 2 micro-batches, on the card and with
    ``--device cpu``: the same logged losses within 1e-4 relative, fp32
    logit rows on both (``TrainConfig(ce_logits="f32")``, as
    ``tiny_train_losses``; the card's default is bf16 rows); K3 and K4
    launched on the card; no retries."""
    import functools

    from livecc_tpu_torch.data.lmm_dataset import write_seek_index
    from livecc_tpu_torch.train import cli, step

    corpus = tmp_path / "anns.jsonl"
    with open(corpus, "w") as f:
        for clip, n in (("a.mp4", 12), ("b.mp4", 9)):
            stream = [[i * 0.45, i * 0.45 + 0.3, f"w{i}"] for i in range(n)]
            f.write(json.dumps([
                {"role": "user", "content": [{"type": "video", "video": str(tmp_path / clip)},
                                             {"type": "text", "text": "commentate"}]},
                {"role": "assistant", "content": [{"type": "text", "text_stream": stream}]}])
                + "\n")
    write_seek_index(str(corpus))
    monkeypatch.setattr(step, "TrainConfig", functools.partial(step.TrainConfig, ce_logits="f32"))
    losses = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        before = dict(build.launch_counts)
        last = cli.main(["--annotation_paths", str(corpus), "--output_dir", str(out),
                         "--total_steps", "2", "--accum_steps", "2", "--log_steps", "1",
                         "--learning_rate", "1e-3", "--warmup_ratio", "0",
                         "--dataloader_num_workers", "1", "--device", device],
                        video_loader=SeededVideo)
        assert last["retries"] == 0
        log = (out / "log.jsonl").read_text().splitlines()
        losses[device] = [json.loads(x)["loss"] for x in log]
        launched = {n: build.launch_counts[n] - before.get(n, 0) for n in
                    ("vit_group_attention", "train_attention_fwd", "train_attention_bwd")}
        assert all(launched.values()) == (device == "cuda"), launched
    assert len(losses["cpu"]) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def packed(b, s, lengths, dev):
    """int32 [b, s]: segments 1..n of ``lengths`` in every row, the rest 0."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[:, at:at + n] = i + 1
        at += n
    return seg.to(dev)


def k4_inputs(gen, b, s, hq, hk, d, dtype, dev):
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d), (b, s, hq, d)))
    return prescaled(q), k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hk,d,lengths", [
    (1, 1000, 28, 4, 128, (400, 350, 200)),     # S % 64 != 0, 3 segments + pad
    (2, 300, 7, 1, 64, (1, 100, 1, 120)),       # one-row segments, pad tail
    (1, 640, 8, 2, 80, (200, 150)),             # all-pad tiles at the end
    (1, 17, 4, 2, 16, (10,)),                   # less than one tile
    (1, 700, 7, 1, 128, "recurring"),           # ids 0, 1, 2 recurring in runs of 37
])
def test_train_attention_noncausal(cuda, dtype, b, s, hq, hk, d, lengths):
    gen = torch.Generator(device=cuda).manual_seed(11)
    qs, k, v, do = k4_inputs(gen, b, s, hq, hk, d, dtype, cuda)
    seg = (((torch.arange(s, device=cuda) // 37) % 3).to(torch.int32)[None].expand(b, s)
           .contiguous() if lengths == "recurring" else packed(b, s, lengths, cuda))
    before = (build.launch_counts["train_attention_fwd"], build.launch_counts["train_attention_bwd"])
    o, lse = train_attention_fwd(qs, k, v, seg, causal=False)
    grads = train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False)
    assert (build.launch_counts["train_attention_fwd"],
            build.launch_counts["train_attention_bwd"]) == (before[0] + 1, before[1] + 1)
    ro, rlse = train_attention_fwd_plain(qs, k, v, seg, causal=False)
    rgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do, causal=False)
    fault = kernel_check.causal_walk(qs, k, v, seg, do, o, lse)
    torch.cuda.synchronize()
    assert kernel_check.close(lse, rlse, torch.float32) <= 1.0
    assert kernel_check.close(fault[1], rlse, torch.float32) > 1.0
    if dtype == torch.float32:
        for out, ref, bad in zip((o, *grads), (ro, *rgrads), (fault[0], *fault[2:])):
            assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
            assert (bad - ref).abs().max().item() > 1e-4 * max(1.0, ref.abs().max().item())
        return
    assert kernel_check.close(o, ro, dtype) <= 1.0
    assert kernel_check.close(fault[0], ro, dtype) > 1.0
    f32 = [x.float() for x in (qs, k, v)]
    r32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg, False),
                                    do.float(), False)
    for out, ref, ref32, bad in zip(grads, rgrads, r32, fault[2:]):
        assert kernel_check.grad_close(out, ref, ref32) <= 1.0
        assert kernel_check.grad_close(bad, ref, ref32) > 1.0
    again = (*train_attention_fwd(qs, k, v, seg, causal=False),
             *train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False))
    assert all(torch.equal(x, y) for x, y in zip((o, lse, *grads), again))


def test_train_flash_attention_noncausal_autograd(cuda):
    """The entry ``train_flash_attention(causal=False)``: autograd through
    the pre-scale and K4's non-causal form, bf16, against the plain
    version's autograd in fp32."""
    from livecc_tpu_torch.ops.attention import train_flash_attention

    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((1, 300, h, 128), generator=gen, device=cuda).bfloat16()
               .requires_grad_() for h in (28, 4, 4))
    mask = torch.arange(300, device=cuda)[None, :] < 260
    w = torch.randn((1, 300, 28, 128), generator=gen, device=cuda) * mask[..., None, None]
    (train_flash_attention(q, k, v, mask, causal=False).float() * w).sum().backward()
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    seg = mask.to(torch.int32)
    (train_attention_fwd_plain(prescaled(ref[0]), ref[1], ref[2], seg, False)[0] * w
     ).sum().backward()
    for x, r in zip((q, k, v), ref):
        assert (x.grad.float() - r.grad).abs().max().item() <= 2e-2 * r.grad.abs().max().item()
