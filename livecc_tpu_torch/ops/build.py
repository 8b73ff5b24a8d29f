"""Build and load the port's CUDA kernels (``livecc_tpu_torch/csrc``).

The kernels have a plain C interface and are compiled by ``nvcc`` for
``sm_90a`` into one shared library, loaded with ``ctypes`` (no PyTorch
headers, so a cold build takes seconds, not minutes). Every ``.cu`` source
is compiled by its own ``nvcc`` process, all started together, and the
objects are then linked into the library. The library is built
at first use into ``build/kernels/<hash>/`` at the repository root (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build
raises with the compiler's output.

Each wrapper that launches a kernel adds one to ``launch_counts[name]``
right after a launch that succeeded, and nowhere else; a run shows it went
through the kernels by reading the counts.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "liblivecc_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

# dtype codes of csrc/attn_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands concurrently; (command, return code, output) each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc) for cmd, proc in procs]
    return [(cmd, proc.returncode, out) for cmd, out, proc in outs]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the hashed build directory (one ``nvcc``
    per source, in parallel, then one link); return the .so path. Compiler
    output (including ``-Xptxas -v`` register and shared memory counts) is
    kept in ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    log = []
    results = _run_all(compiles)
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for cmd, rc, out in results:
        log.append(f"{' '.join(cmd)}\n[exit {rc}]\n{out}")
    (out_dir / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-1]}:\n{out[-8000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declare every C signature."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    # bf16 K1 also takes (kv_maps, layer, workspace, nsplit) before the stream
    lib.livecc_flash_prefill.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                         i32, i32, i32, i32, i32, i32, strides, f32,
                                         ptr, i32, ptr, i32, ptr]
    lib.livecc_prefill_kv_map.argtypes = [ptr, i32, i32, i32, i32, i32, strides, ptr]
    # the decode entry points end in (workspace, counters, nsplit, kv_maps, layer, stream)
    lib.livecc_flash_decode.argtypes = [i32, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, strides, f32, ptr, ptr, i32,
                                        ptr, i32, ptr]
    lib.livecc_decode_kv_map.argtypes = [ptr, i32, i32, i32, i32, i32, strides, i32, ptr]
    lib.livecc_flash_prefill_int8.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                              i32, i32, i32, i32, i32, i32, strides, f32, ptr]
    lib.livecc_flash_decode_int8.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                             i32, i32, i32, i32, i32, strides, f32, ptr, ptr,
                                             i32, ptr, i32, ptr]
    lib.livecc_vit_attention.argtypes = [i32, ptr, ptr, ptr, ptr, ptr,
                                         i32, i32, i32, i32, i32, strides, f32, ptr]
    # the training entry points end in (..., d, causal, strides, stream)
    lib.livecc_train_attention_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                               i32, i32, i32, i32, i32, i32, strides, ptr]
    lib.livecc_train_attention_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                               ptr, i32, i32, i32, i32, i32, i32, strides, ptr]
    lib.livecc_w8a16_gemm.argtypes = [i32, i32, ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr,
                                      i32, i32, i32, i32, i32, i32, ptr]
    for fn in (lib.livecc_flash_prefill, lib.livecc_prefill_kv_map, lib.livecc_flash_decode,
               lib.livecc_decode_kv_map,
               lib.livecc_flash_prefill_int8, lib.livecc_flash_decode_int8,
               lib.livecc_vit_attention,
               lib.livecc_train_attention_fwd, lib.livecc_train_attention_bwd,
               lib.livecc_w8a16_gemm):
        fn.restype = i32
    return lib


def stride_array(*tensors_dims) -> ctypes.Array:
    """Flatten (tensor, dims) pairs into a C int64 array of element strides
    (the launchers copy it during the call, so one array per stride tuple is
    built once and reused)."""
    vals = []
    for t, dims in tensors_dims:
        strides = t.stride()
        vals += (strides[d] for d in dims)
    return _stride_array(tuple(vals))


@functools.lru_cache(maxsize=1024)
def _stride_array(vals: tuple) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*vals)


def current_stream(device: torch.device) -> int:
    """Raw handle of ``device``'s current CUDA stream, the launchers' last
    argument: ``torch.cuda.current_stream(device).cuda_stream``, read
    without building a Stream object (the decode step launches K2 once per
    layer) through ``torch._C._cuda_getCurrentRawStream`` where this torch
    has it, else through the public call. A GPU test holds the two equal."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if device.index is None else device.index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` when another device is current (the C
    launchers launch on the current one), else a context that does nothing."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: mixed devices or dtypes, an
    unsupported dtype, a head dim that is not unit-stride, or a head dim that
    is not a multiple of 8 up to 128."""
    dev, dt, d = tensors[0].device, tensors[0].dtype, tensors[0].shape[-1]
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} not supported (float32, bfloat16)")
    if d <= 0 or d > 128 or d % 8:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8 and <= 128")
    for t in tensors:
        if t.device != dev or t.dtype != dt or t.shape[-1] != d:
            raise ValueError(f"{name}: operands must share device, dtype and head dim, got "
                             f"{[(x.device, x.dtype, tuple(x.shape)) for x in tensors]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head dim must be unit-stride, got strides {t.stride()}")


def check_bf16_rows(name: str, *tensors: torch.Tensor) -> None:
    """What the bf16 tensor-core kernels (``csrc/wgmma_attention.cuh``: K1,
    K3; ``csrc/train_wgmma_attention.cuh`` and
    ``train_wgmma_attention_bwd.cuh``: K4) take besides ``check_operands``: a
    head dim that is a multiple of 16, and rows that TMA can read (base and
    every stride but the head dim's a multiple of 16 bytes). No-op for other
    dtypes."""
    if tensors[0].dtype != torch.bfloat16:
        return
    d = tensors[0].shape[-1]
    if d % 16:
        raise ValueError(f"{name}: bf16 head_dim {d} must be a multiple of 16")
    for t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: bf16 rows must be 16-byte aligned, got base "
                             f"{t.data_ptr() % 16} mod 16 and strides {t.stride()}")


def row_scalars(x, batch: int, device: torch.device) -> torch.Tensor:
    """Scalar or [B] -> contiguous int32 [B] on ``device``."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.device == device
            and x.shape == (batch,) and x.is_contiguous()):
        return x
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(batch).contiguous()


def launch(name: str, fn, *args) -> None:
    """Call a C launcher; raise on a non-zero cudaError_t, count on success."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    launch_counts[name] += 1
