"""Training loop: dataset -> step -> checkpoints -> resume, on one GPU or a mesh.

Port of ``livecc_tpu/train/trainer.py``:

  * each window draws ``accum_steps`` sample indices from a seeded
    ``random.Random``; with ``pack_seq`` the samples are packed into rows of
    that many tokens (segment-id attention), fetching more until the window
    is full and carrying the unpacked leftovers to the next step;
  * a background thread loads and collates batch N+1 while the device runs
    step N;
  * metrics are appended to ``<output_dir>/log.jsonl``: JAX's record
    (step, loss, supervised tokens, elapsed seconds) and the step's timing:
    ``wall_s`` (since the previous record, or train()'s start, to the loss
    read back), ``load_s`` (the step's window loaded and collated, in the
    prefetch thread but the first), ``save_s`` where the step saved,
    ``restored_step`` and ``restore_s`` in the first record after a
    restore, and on a GPU ``peak_gib`` (the device's peak allocation since
    the previous record);
  * ``save`` writes ``<output_dir>/ckpt/<step>/state.pt`` with ``torch.save``
    (params, optimizer state, step: orbax is not on the GPU machine) every
    ``save_steps`` and at the last step; ``try_restore`` loads the latest.

The dataset is any sequence of processed samples (``input_ids [1, S]``,
``labels``, ``position_ids [3, 1, S]``, ``pixel_patches``,
``video_grid_thw``), as ``LMMDataset.__getitem__`` returns them.

With ``mesh`` (``core/mesh.py``; one process a card, every rank runs this
loop): the model is split over the model axis and its trainable state is
ZeRO-2's (``parallel/sharding.py``), the step is ``make_mesh_train_step``
and a window holds ``accum_steps x n_data`` samples. Every rank draws the
same indices from the same seed (JAX's one host, ``sample_indices``);
data rank d collates only micro-step a's row d, ``samples[a * n_data +
d]`` (JAX's collate order), and loads only those samples itself, so the
model ranks of one data index each load the same ones (with ``pack_seq``
every rank loads the whole window, which packing reads whole). Rank 0
alone writes ``log.jsonl`` and ``state.pt``; the state is the single-card
format, gathered tensor by tensor into rank 0's host memory
(``gather_state``), and restores on any mesh or on one card by slicing
(``load_state``, the file mapped from disk).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.core.mesh import Mesh
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.parallel.sharding import Zero2, gather_state, load_state, shard_params
from livecc_tpu_torch.train.data import collate, collate_packed_rows, pack_samples
from livecc_tpu_torch.train.step import (TrainConfig, make_mesh_train_step, make_optimizer,
                                         make_train_step, split_frozen)


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "output"
    total_steps: int = 1000
    accum_steps: int = 8
    # checkpoint every save_steps and at the last step; None saves nothing
    save_steps: int | None = 1000
    log_steps: int = 10
    seed: int = 0
    resume: bool = True
    loader_workers: int = 4           # per-sample fetch threads
    pack_seq: int | None = None       # pack samples into rows of this many tokens


class Trainer:
    """The training loop; ``model``'s trainable parameters are updated in
    place. Without ``mesh`` one device (batch rows = 1); with it this
    rank's part of the mesh (batch rows = n_data; ``model`` is sharded
    here)."""

    def __init__(self, model: Qwen2VL, cfg: ModelConfig, tcfg: TrainConfig, run: TrainerConfig,
                 dataset: Sequence[dict[str, Any]], mesh: Mesh | None = None):
        self.model = model
        self.cfg = cfg
        self.tcfg = tcfg
        self.run = run
        self.dataset = dataset
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.optimizer = make_optimizer(tcfg)
        if mesh is None:
            self.batch_rows = 1
            self.opt_state = self.optimizer.init(split_frozen(model, tcfg.freeze_modules)[0])
            self.step_fn = make_train_step(cfg, tcfg, self.optimizer)
        else:
            self.batch_rows = mesh.n_data
            shard_params(model, cfg, mesh, training=True)
            self.zero = Zero2(split_frozen(model, tcfg.freeze_modules)[0], mesh)
            self.opt_state = self.zero.init_state(tcfg.adam_mu_dtype)
            self.step_fn = make_mesh_train_step(cfg, tcfg, self.optimizer, self.zero)
        self.is_main = mesh is None or mesh.rank == 0
        self.step = 0
        self._restored: dict = {}         # restored_step, restore_s: for the next record
        self._pack_buf: list = []
        os.makedirs(run.output_dir, exist_ok=True)
        self._ckpt_dir = os.path.abspath(os.path.join(run.output_dir, "ckpt"))
        self._log_path = os.path.join(run.output_dir, "log.jsonl")
        if run.resume:
            self.try_restore()

    # -- checkpointing -----------------------------------------------------

    def save(self) -> float:
        """Write ``ckpt/<step>/state.pt``; returns the seconds it took. On a
        mesh every rank takes part and rank 0 writes."""
        t0 = time.perf_counter()
        if self.mesh is None:
            state = {"params": self.model.state_dict(), "opt_state": self.opt_state,
                     "step": self.step}
        else:
            state = gather_state(self.model, self.zero, self.opt_state, self.step)
            if state is None:
                return time.perf_counter() - t0
        path = os.path.join(self._ckpt_dir, str(self.step))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        return time.perf_counter() - t0

    def latest_step(self) -> int | None:
        if not os.path.isdir(self._ckpt_dir):
            return None
        steps = [int(d) for d in os.listdir(self._ckpt_dir)
                 if d.isdigit() and os.path.exists(os.path.join(self._ckpt_dir, d, "state.pt"))]
        return max(steps) if steps else None

    def try_restore(self) -> bool:
        latest = self.latest_step()
        if latest is None:
            return False
        t0 = time.perf_counter()
        path = os.path.join(self._ckpt_dir, str(latest), "state.pt")
        if self.mesh is None:
            state = torch.load(path, map_location=self.device)
            self.model.load_state_dict(state["params"])
            mu, nu = self.opt_state["mu"], self.opt_state["nu"]
            for name in mu:
                mu[name].copy_(state["opt_state"]["mu"][name])
                nu[name].copy_(state["opt_state"]["nu"][name])
            self.opt_state["count"] = state["opt_state"]["count"]
        else:       # each rank slices its part of the mapped file
            state = torch.load(path, map_location="cpu", mmap=True)
            load_state(self.model, self.zero, self.opt_state, state)
        self.step = state["step"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._restored = {"restored_step": latest, "restore_s": time.perf_counter() - t0}
        return True

    # -- loop --------------------------------------------------------------

    def _log(self, record: dict) -> None:
        if not self.is_main:
            return
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def sample_indices(self, rng: random.Random) -> list[int]:
        """One window of accum_steps x batch_rows indices."""
        n = len(self.dataset)
        return [rng.randrange(n) for _ in range(self.run.accum_steps * self.batch_rows)]

    def _fetch(self, indices: list[int]):
        if self.run.loader_workers > 1:
            with ThreadPoolExecutor(max_workers=self.run.loader_workers) as pool:
                return list(pool.map(self.dataset.__getitem__, indices))
        return [self.dataset[i] for i in indices]

    def _load_timed(self, rng: random.Random):
        t0 = time.perf_counter()
        batch = self._load_batch(rng)
        return batch, time.perf_counter() - t0

    def _rows(self, window: list) -> list:
        """This data rank's rows of a window in collate's order: micro-step
        a's row d is ``window[a * n_data + d]``."""
        if self.mesh is None:
            return window
        return window[self.mesh.d::self.mesh.n_data]

    def _load_batch(self, rng: random.Random):
        indices = self.sample_indices(rng)
        if self.run.pack_seq is None:
            samples = self._fetch(self._rows(indices))
            return collate(samples, self.cfg, rows=1 if self.mesh else self.batch_rows,
                           device=self.device)
        samples = self._fetch(indices)
        # one window needs more samples than rows: fetch until full (bounded)
        # and carry the unpacked leftovers to the next step
        target = self.run.accum_steps * self.batch_rows
        self._pack_buf.extend(samples)
        for _ in range(8):
            packed, left = pack_samples(self._pack_buf, self.run.pack_seq, max_rows=target)
            if len(packed) >= target:
                break
            self._pack_buf.extend(self._fetch(self.sample_indices(rng)))
        else:
            packed, left = pack_samples(self._pack_buf, self.run.pack_seq, max_rows=target)
        if not packed:
            raise RuntimeError(
                f"pack_seq={self.run.pack_seq} produced no packed rows from "
                f"{len(self._pack_buf)} fetched samples; the samples are longer than "
                "pack_seq, raise it")
        self._pack_buf = left
        if self.mesh is not None:
            return collate_packed_rows(self._rows(packed), self.cfg, rows=1,
                                       accum=self.run.accum_steps, device=self.device)
        return collate_packed_rows(packed, self.cfg, rows=self.batch_rows,
                                   accum=self.run.accum_steps, device=self.device)

    def train(self, on_step=None) -> dict:
        """Run to total_steps with one-batch lookahead prefetch; returns the
        last logged record. ``on_step(step, batch, metrics)``, if given, is
        called after every step (the metrics are device tensors)."""
        rng = random.Random(self.run.seed + self.step)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        since = time.perf_counter()
        last = {}
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._load_timed, rng)
            while self.step < self.run.total_steps:
                batch, load_s = future.result()
                if self.step + 1 < self.run.total_steps:
                    future = pool.submit(self._load_timed, rng)
                self.model, self.opt_state, metrics = self.step_fn(self.model, self.opt_state,
                                                                   batch)
                self.step += 1
                if on_step is not None:
                    on_step(self.step, batch, metrics)
                record = None
                if self.step % self.run.log_steps == 0 or self.step == self.run.total_steps:
                    record = {"step": self.step, "loss": float(metrics["loss"]),
                              "tokens": int(metrics["tokens"]),
                              "elapsed_s": round(time.time() - t0, 2)}
                    record.update(wall_s=time.perf_counter() - since, load_s=load_s,
                                  **self._restored)
                    self._restored = {}
                    if cuda:
                        record["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
                    dropped = int(metrics["ce_dropped"])
                    if dropped:
                        record["ce_dropped"] = dropped
                        warnings.warn(f"ce_sup_bucket dropped {dropped} supervised tokens "
                                      "this step; raise TrainConfig.ce_sup_bucket")
                save = self.run.save_steps
                if save and (self.step % save == 0 or self.step == self.run.total_steps):
                    save_s = self.save()
                    if record is not None:
                        record["save_s"] = save_s
                if record is not None:
                    self._log(record)
                    last = record
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(self.device)
                    since = time.perf_counter()
        return last
