"""Web demo: real-time commentary + video QA in the browser, on the port.

Port of ``livecc_tpu/demo/app.py`` (the reference demo/app.py's Gradio
two-mode chat UI with a JS ``video.currentTime`` poll loop, :148-176, on the
stdlib http.server). The browser plays the video locally and polls
``/tick?t=<currentTime>`` every 500 ms, whether or not the last poll has
returned; the server advances the live engine to that timestamp and returns
any new commentary bubbles as JSON ``[[[t0, t1], text], ...]``. ``POST /qa``
answers a chat question (text/plain) over the same KV cache. Ticks and QA
turns take one lock, so overlapping polls wait for the chunk in flight.

Usage:
  python -m livecc_tpu_torch.demo.app --video clip.mp4 [--model ckpt] \\
      [--port 7860] [--speculative] [--quantize-weights] [--device cuda|cpu]

The model runs on the card unless --device cpu asks for the CPU (the
kernels' plain versions); without CUDA, --device cuda raises. Without
--model a tiny random-init model and a byte tokenizer run in fp32 (smoke
mode, as ``demo.cli``). --quantize-weights (int8 matmul weights through K5)
is off by default.
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html>
<html><head><title>LiveCC demo</title><style>
body { font-family: sans-serif; margin: 2em; max-width: 900px; }
#log div { margin: 4px 0; padding: 6px 10px; border-radius: 8px; background: #eef; }
#log div.qa { background: #efe; }
video { width: 100%; border-radius: 8px; }
</style></head><body>
<h2>LiveCC — real-time commentary</h2>
<video id="v" src="/video" controls></video>
<div id="log"></div>
<form id="qaf"><input id="q" size="60" placeholder="Ask about the video..."/>
<button>Ask</button></form>
<script>
const v = document.getElementById('v'), log = document.getElementById('log');
setInterval(async () => {
  if (v.paused) return;
  const r = await fetch('/tick?t=' + v.currentTime);
  for (const [span, text] of await r.json()) {
    const d = document.createElement('div');
    d.textContent = `[${span[0].toFixed(1)}-${span[1].toFixed(1)}s] ${text}`;
    log.prepend(d);
  }
}, 500);
document.getElementById('qaf').onsubmit = async (e) => {
  e.preventDefault();
  const q = document.getElementById('q').value;
  const r = await fetch('/qa', {method: 'POST', body: q});
  const d = document.createElement('div'); d.className = 'qa';
  d.textContent = 'Q: ' + q + ' — A: ' + await r.text();
  log.prepend(d);
};
</script></body></html>"""

class DemoServer:
    """One live session over ``video_path`` on ``demo.cli.build_engine``'s
    engine. ``tokenizer`` overrides the checkpoint's; ``video_loader`` goes
    to ``LiveCC`` (frames from memory where no decoder is built)."""

    def __init__(self, video_path: str, model_path: str | None, query: str,
                 speculative: bool = False, quantize_weights: bool | None = None, *,
                 device: str = "cuda", tokenizer=None, video_loader=None):
        from livecc_tpu_torch.demo import cli
        from livecc_tpu_torch.engine.live import LiveCC
        from livecc_tpu_torch.utils.device import device_for

        device_for(device, "demo.app", " (--device cpu runs the plain versions on the CPU)")
        self.video_path = video_path
        self.query = query
        self.engine = cli.build_engine(model_path, speculative=speculative, device=device,
                                       tokenizer=tokenizer, quantize_weights=quantize_weights)
        self.live = (LiveCC(self.engine) if video_loader is None
                     else LiveCC(self.engine, video_loader=video_loader))
        self.session = self.live.open(video_path)
        self.lock = threading.Lock()

    def _on_device(self):
        """The engine's card made current for this request's thread (a new
        thread starts on its process's default device)."""
        from livecc_tpu_torch.ops import build

        return build.on_device(self.engine.device)

    def tick(self, t: float) -> list:
        """Advance the session to playback time ``t``: the new
        ``[[t0, t1], text]`` bubbles."""
        with self.lock, self._on_device():
            return [[list(span), text] for span, text in
                    self.live.live_cc(self.session, t, query=self.query)]

    def qa(self, message: str) -> str:
        """Answer ``message`` over the session's cache."""
        with self.lock, self._on_device():
            return self.live.video_qa(self.session, message)


def make_handler(server: DemoServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body: bytes, ctype: str = "text/html"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                self._send(PAGE.encode())
            elif url.path == "/video":
                with open(server.video_path, "rb") as f:
                    self._send(f.read(), "video/mp4")
            elif url.path == "/tick":
                t = float(urllib.parse.parse_qs(url.query).get("t", ["0"])[0])
                self._send(json.dumps(server.tick(t)).encode(), "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/qa":
                n = int(self.headers.get("Content-Length", 0))
                message = self.rfile.read(n).decode()
                self._send(server.qa(message).encode(), "text/plain")
            else:
                self.send_error(404)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--video", required=True)
    parser.add_argument("--model", default=None,
                        help="HF checkpoint dir (safetensors + tokenizer.json)")
    parser.add_argument("--query", default="Please describe the video.")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--speculative", action="store_true",
                        help="fused on-device lookahead decoding (engine/speculative.py)")
    parser.add_argument("--quantize-weights", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="int8 matmul weights (ops/quant.py, the W8A16 kernel K5); "
                             "default off")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)
    server = DemoServer(args.video, args.model, args.query, speculative=args.speculative,
                        quantize_weights=args.quantize_weights, device=args.device)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(server))
    print(f"serving on http://localhost:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
