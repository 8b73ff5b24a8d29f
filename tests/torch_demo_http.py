"""What the web demo's tests share (``test_torch_demo.py``, which imports
jax, and ``test_torch_demo_gpu.py``, which must not): a server on a
loopback port, a client, and a clip served from an .npy file through a
``video_loader``."""

import contextlib
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

# the in-memory clip: 8 s at the engine's 2 fps, at the size the visual
# budget gives a small frame (the loader serves no other size)
LOADER_FPS = 2.0
LOADER_SHAPE = (16, 280, 280, 3)


@contextlib.contextmanager
def serving(server, make_handler):
    """``server`` behind a threaded HTTP server on 127.0.0.1, port 0: its base URL."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.read()


def post(url: str, body: str) -> str:
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read().decode()


class Frames:
    """``VideoReader``'s API over frames in memory, frame i at i / LOADER_FPS
    s, served at their own size only."""

    def __init__(self, frames):
        self.frames, self.avg_fps = frames, LOADER_FPS
        self.frame_size = frames.shape[1:3]
        self.pts_seconds = np.arange(len(frames)) / LOADER_FPS

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        assert tuple(out_hw) == self.frame_size
        return self.frames[np.asarray(indices)]


def write_clip(path: str, seed: int = 1) -> str:
    """Seeded uint8 frames of LOADER_SHAPE saved at ``path`` (an .npy file)."""
    np.save(path, np.random.RandomState(seed).randint(0, 256, LOADER_SHAPE, dtype=np.uint8))
    return path


def npy_loader(path: str) -> Frames:
    """The ``video_loader`` of a clip that ``write_clip`` saved."""
    return Frames(np.load(path))
