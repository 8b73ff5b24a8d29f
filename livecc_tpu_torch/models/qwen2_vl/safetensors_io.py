"""Read HF ``*.safetensors`` checkpoints without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
...}``), then the raw little-endian tensor bytes, offsets counted from the
end of the header. ``Shards`` opens every shard of a checkpoint directory,
reads the headers, and reads a tensor's bytes (one ``pread``) only when it
is asked for, into a tensor of its own: a loader that copies each tensor
out and drops it holds about one tensor on the host at a time. (A
memory-mapped reader can leave every page it touched resident, up to the
whole checkpoint, whatever it advises the kernel.)

The JAX package reads shards with ``safetensors.safe_open(framework="np")``,
which reads bf16 only where ``ml_dtypes`` is imported (by jax); this reader
needs neither. It writes nothing (``tools/checkpoint.py`` writes).
"""

from __future__ import annotations

import json
import os
import struct
import sys
from collections.abc import Mapping

import torch

INDEX_FILE = "model.safetensors.index.json"
DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}


def read_header(path: str) -> tuple[dict, int]:
    """(tensor entries without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end of a {size}-byte file")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data_end = size - 8 - n
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise TypeError(f"{path}: tensor {name} has dtype {e['dtype']}, not one of "
                            f"{sorted(DTYPES)}")
        begin, end = e["data_offsets"]
        numel = 1
        for s in e["shape"]:
            numel *= s
        nbytes = numel * torch.empty((), dtype=DTYPES[e["dtype"]]).element_size()
        if not 0 <= begin <= end <= data_end or end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name} spans bytes [{begin}, {end}) of "
                             f"{data_end}, want {nbytes} bytes for {e['dtype']} {e['shape']}")
    return header, 8 + n


def shard_files(path: str) -> list[str]:
    """The shard files of a checkpoint directory: those that
    ``model.safetensors.index.json`` names when it is there, else every
    ``*.safetensors`` file, in name order."""
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {path}")
    return [os.path.join(path, f) for f in files]


class Shards(Mapping):
    """``{name: tensor}`` over the shards of a checkpoint directory; each
    lookup reads the tensor's bytes from its shard into a new CPU tensor.
    A tensor name found in two shards, or one the index places in another
    shard than holds it, raises. Use as a context manager."""

    def __init__(self, path: str):
        if sys.byteorder != "little":
            raise RuntimeError("safetensors data is little-endian; this host is not")
        self._fds: list[int] = []
        self._entries: dict[str, tuple[int, dict, int]] = {}   # name -> (fd, entry, data start)
        index = os.path.join(path, INDEX_FILE)
        weight_map = None
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
        try:
            for file in shard_files(path):
                header, start = read_header(file)
                self._fds.append(os.open(file, os.O_RDONLY))
                for name, e in header.items():
                    if name in self._entries:
                        raise ValueError(f"{path}: tensor {name} is in two shards")
                    if weight_map is not None and weight_map.get(name) != os.path.basename(file):
                        raise ValueError(f"{path}: {INDEX_FILE} places {name} in "
                                         f"{weight_map.get(name)}, found in {file}")
                    self._entries[name] = (self._fds[-1], e, start)
            if weight_map is not None and set(weight_map) - set(self._entries):
                raise ValueError(f"{path}: {INDEX_FILE} names tensors no shard holds: "
                                 f"{sorted(set(weight_map) - set(self._entries))[:8]}")
        except BaseException:
            self.close()
            raise

    def __getitem__(self, name: str) -> torch.Tensor:
        fd, e, start = self._entries[name]
        begin, end = e["data_offsets"]
        raw = torch.empty(end - begin, dtype=torch.uint8)
        view, at = memoryview(raw.numpy()), 0
        while at < end - begin:
            n = os.preadv(fd, [view[at:]], start + begin + at)
            if n <= 0:
                raise IOError(f"tensor {name}: short read at byte {at} of {end - begin}")
            at += n
        return raw.view(DTYPES[e["dtype"]]).reshape(e["shape"])

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        for fd in self._fds:
            os.close(fd)
        self._fds = []

    def __enter__(self) -> "Shards":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
