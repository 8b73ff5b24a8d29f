"""Python surface over the native FFmpeg decoder (ctypes).

Port of ``livecc_tpu/vision_io/video_reader.py`` over the port's own copy of
the decoder source (``native/video_decoder.cpp``, the same C API): a
decord-style reader with the PTS table, ``get_batch`` over repeated or
monotonic indices, the average fps, and native-size or pre-scaled (libswscale
bicubic) output; ``load_audio`` (mono float32 PCM at a sample rate, through
libswresample), and the writers ``encode_test_video``, ``encode_test_audio``
and ``encode_video_with_audio``.

The shared library is compiled with ``g++`` at first use into
``build/video/<hash>/`` at the repository root (listed in ``.gitignore``),
keyed by a hash of the source and flags as ``ops/build.py`` keys the
kernels; it needs the FFmpeg development libraries. ``has_ffmpeg()`` asks
``pkg-config`` whether they are installed; ``is_available()`` whether the
library builds and loads, which gates tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "video_decoder.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "video"
LIB_NAME = "libvideodec.so"
FFMPEG = ("libavformat", "libavcodec", "libavutil", "libswscale", "libswresample")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample")

_lib = None
_lock = threading.Lock()


def has_ffmpeg() -> bool:
    """Whether ``pkg-config`` finds the FFmpeg development libraries the
    decoder links."""
    if shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", *FFMPEG]).returncode == 0


def build_library() -> Path:
    """Compile the decoder into its hashed build directory (once per source
    and flags); return the .so path. A failed build raises with g++'s
    output."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the video decoder failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        u8p, f64p, f32p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_double,
                                                       ctypes.c_float))
        i64, i32, cstr = ctypes.c_int64, ctypes.c_int, ctypes.c_char_p
        sigs = {
            "vr_open": ([cstr], i64),
            "vr_open_bytes": ([u8p, i64], i64),
            "vr_num_frames": ([i64], i64),
            "vr_avg_fps": ([i64], ctypes.c_double),
            "vr_frame_size": ([i64, ctypes.POINTER(i32), ctypes.POINTER(i32)], i32),
            "vr_pts_seconds": ([i64, f64p], i32),
            "vr_get_batch": ([i64, ctypes.POINTER(i64), i64, u8p, i32, i32], i32),
            "vr_close": ([i64], None),
            "vr_last_error": ([], cstr),
            "vr_encode_test_video": ([cstr, u8p, i64, i32, i32, i32], i32),
            "vr_audio_open": ([cstr, i32], i64),
            "vr_audio_len": ([i64], i64),
            "vr_audio_copy": ([i64, f32p], i32),
            "vr_audio_close": ([i64], None),
            "vr_encode_test_audio": ([cstr, f32p, i64, i32], i32),
            "vr_encode_video_with_audio": ([cstr, u8p, i64, i32, i32, i32, f32p, i64, i32], i32),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


class VideoReader:
    """PTS-indexed random-access reader over one video.

    ``source`` is a filesystem path, raw container ``bytes``, or a callable
    returning bytes (the reference's ``remote_loader`` hook shape).
    """

    def __init__(self, source):
        self._h = 0
        self._lib = _load()
        if callable(source):
            source = source()
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf = (ctypes.c_uint8 * len(source)).from_buffer_copy(source)
            self._h = self._lib.vr_open_bytes(buf, len(source))
        else:
            self._h = self._lib.vr_open(os.fsencode(source))
        if self._h == 0:
            raise IOError(f"cannot open video: {self._lib.vr_last_error().decode()}")
        self._n = int(self._lib.vr_num_frames(self._h))
        self._pts: np.ndarray | None = None

    def __len__(self) -> int:
        return self._n

    @property
    def avg_fps(self) -> float:
        return float(self._lib.vr_avg_fps(self._h))

    @property
    def frame_size(self) -> tuple[int, int]:
        h, w = ctypes.c_int(), ctypes.c_int()
        self._lib.vr_frame_size(self._h, ctypes.byref(h), ctypes.byref(w))
        return h.value, w.value

    @property
    def pts_seconds(self) -> np.ndarray:
        """Per-frame display timestamps (the reference's ``_frame_pts[:, 1]``)."""
        if self._pts is None:
            out = np.empty(self._n, np.float64)
            if self._lib.vr_pts_seconds(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))):
                raise IOError("pts read failed")
            self._pts = out
        return self._pts

    def get_batch(self, indices, out_hw: tuple[int, int] | None = None) -> np.ndarray:
        """Decode frames at display-order ``indices`` -> [T, H, W, 3] uint8,
        scaled inside the native layer to ``out_hw`` when given."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        h, w = self.frame_size if out_hw is None else out_hw
        out = np.empty((len(idx), h, w, 3), np.uint8)
        rc = self._lib.vr_get_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            0 if out_hw is None else h, 0 if out_hw is None else w,
        )
        if rc != 0:
            raise IOError(f"get_batch failed: {self._lib.vr_last_error().decode()}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.vr_close(self._h)
            self._h = 0

    def __del__(self):
        self.close()


def encode_test_video(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Write [T, H, W, 3] uint8 frames as an mpeg4 clip (tests, chip_smoke)."""
    lib = _load()
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"encode_test_video: frames must be [T, H, W, 3], got {frames.shape}")
    rc = lib.vr_encode_test_video(
        os.fsencode(path), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w, fps)
    if rc != 0:
        raise IOError(f"encode failed: {lib.vr_last_error().decode()}")


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Decode a media file's first audio stream -> mono float32 [T] at
    ``sample_rate`` (decord AudioReader equivalent; reference
    data/production/distributed_whisperx.py:14-16)."""
    lib = _load()
    h = lib.vr_audio_open(os.fsencode(path), sample_rate)
    if h == 0:
        raise IOError(f"cannot open audio: {lib.vr_last_error().decode()}")
    try:
        n = int(lib.vr_audio_len(h))
        out = np.empty(n, np.float32)
        if n and lib.vr_audio_copy(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
            raise IOError("audio copy failed")
        return out
    finally:
        lib.vr_audio_close(h)


def encode_test_audio(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float samples as a 16-bit WAV (tests)."""
    lib = _load()
    samples = np.ascontiguousarray(samples, np.float32)
    rc = lib.vr_encode_test_audio(
        os.fsencode(path), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), sample_rate,
    )
    if rc != 0:
        raise IOError(f"audio encode failed: {lib.vr_last_error().decode()}")


def encode_video_with_audio(path: str, frames: np.ndarray, fps: int,
                            samples: np.ndarray, sample_rate: int) -> None:
    """One mp4 with an mpeg4 video track AND an AAC audio track (reference
    demo/render/video.py:186-200 muxes the TTS track into the final mp4).
    ``samples`` is mono float32 PCM; rates outside AAC's set are resampled
    in the native layer."""
    lib = _load()
    frames = np.ascontiguousarray(frames, np.uint8)
    samples = np.ascontiguousarray(samples, np.float32)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"encode_video_with_audio: frames must be [T, H, W, 3], got "
                         f"{frames.shape}")
    rc = lib.vr_encode_video_with_audio(
        os.fsencode(path), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, fps, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), sample_rate,
    )
    if rc != 0:
        raise IOError(f"mux encode failed: {lib.vr_last_error().decode()}")
