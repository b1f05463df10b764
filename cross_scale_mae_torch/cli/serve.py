"""Online inference server: npz checkpoint -> HTTP, on the GPU.

Counterpart of ``cross_scale_mae_tpu/cli/serve.py``: the model runs behind a
dynamic micro-batching queue (``serving.MicroBatcher``), so concurrent
requests are coalesced up to ``--batch_size`` rows and answered from one
batched forward.

Endpoints (stdlib ThreadingHTTPServer; one handler thread per connection,
all funneling into the batcher):

* ``GET /healthz`` — liveness + warm-up state.
* ``GET /info`` — model/input contract (kind, canvas, batch, config).
* ``GET /stats`` — serving counters (requests, dispatches, mean batch fill,
  per-dispatch latency p50/p99, queue depth).
* ``POST /predict`` — body = ``.npy`` bytes, uint8 ``(n, canvas, canvas,
  C)``; response ``.npy`` float32 pooled features. ``Accept:
  application/json`` returns a JSON list instead.
* ``POST /predict_image`` — body = encoded image (JPEG/PNG...); decoded,
  resized to the canvas, served as a batch of one; JSON response. 3-channel
  models only.

Usage:
    python -m cross_scale_mae_torch.cli.serve --ckpt params.npz \
        --batch_size 64 --port 8901            # on the GPU
    python -m cross_scale_mae_torch.cli.serve --ckpt params.npz --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import io
import json
import threading

import numpy as np


def log(*args) -> None:
    now = datetime.datetime.now().strftime("[%H:%M:%S.%f")[:-3] + "]"
    print(now, *args, flush=True)


def get_args_parser():
    p = argparse.ArgumentParser("Cross-Scale MAE inference server (PyTorch)",
                                add_help=False)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", default=None,
                     help="npz parameter file with its __config__ entry (as "
                          "written by save_params_npz)")
    src.add_argument("--artifact", default=None,
                     help="exported artifact: not ported yet (ROADMAP.md)")
    p.add_argument("--step", default=None, type=int,
                   help="Orbax checkpoint step: not ported yet (ROADMAP.md)")
    p.add_argument("--pool", default="cls", choices=["cls", "mean", "tokens"])
    p.add_argument("--dataset_type", default="fmow_rgb")
    p.add_argument("--canvas_scale", default=None, type=float)
    p.add_argument("--batch_size", default=64, type=int,
                   help="largest dispatch = max coalesced request rows")
    p.add_argument("--max_delay_ms", default=5.0, type=float,
                   help="batching window: how long a request waits for "
                        "co-riders before dispatch")
    p.add_argument("--batch_buckets", default=None, type=int, nargs="+",
                   help="dispatch sizes (largest must equal --batch_size): "
                        "each dispatch pads to the SMALLEST bucket that fits")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8901, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:1, cpu)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warm-up call before the socket opens")
    p.add_argument("--max_request_mb", default=256, type=int,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--max_queue_rows", default=None, type=int,
                   help="backpressure: reject new requests (429) once this "
                        "many rows are queued (default 32x the batch; "
                        "0 = unbounded)")
    p.add_argument("--deadline_ms", default=30000.0, type=float,
                   help="per-request end-to-end budget: requests not "
                        "answered within this window get 504 and are "
                        "purged from the queue (0 = no deadline)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 weights: not ported yet (ROADMAP.md)")
    p.add_argument("--native_kernels", action="store_true",
                   help="accepted for compatibility: the port always runs "
                        "the checkpoint's attention implementation")
    p.add_argument("--data_parallel", action="store_true",
                   help="data-parallel serving: not ported yet (ROADMAP.md)")
    return p


def build_app(args, model=None):
    """Load the model (unless one is injected), warm it, and return
    (HTTPServer, batcher)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from cross_scale_mae_torch.serving import (
        DeadlineExceededError,
        MicroBatcher,
        QueueFullError,
        build_serving_model,
    )

    if args.artifact:
        raise SystemExit(
            "--artifact: serving an exported artifact is not ported yet "
            "(ROADMAP.md, queue 1 item 15); serve the npz with --ckpt")
    if args.quantize:
        raise SystemExit(
            "--quantize: int8 serving is not ported yet (ROADMAP.md, queue 1 "
            "item 15)")
    if args.data_parallel:
        raise SystemExit(
            "--data_parallel: data-parallel serving is not ported yet "
            "(ROADMAP.md, queue 1 items 11 and 15)")
    if args.native_kernels:
        log("--native_kernels has no effect here: the port always serves "
            "the checkpoint's attention_impl (pallas_v3 runs the CUDA kernel)")
    if model is None:
        model = build_serving_model(
            args.ckpt, args.step, pool=args.pool,
            dataset_type=args.dataset_type, canvas_scale=args.canvas_scale,
            batch_size=args.batch_size, device=args.device,
        )

    buckets = args.batch_buckets
    if buckets and model.batch_size is not None \
            and max(buckets) != model.batch_size:
        raise SystemExit(
            f"largest --batch_buckets entry {max(buckets)} must equal "
            f"--batch_size {model.batch_size}")
    state = {"warm": False}
    if not args.no_warmup:
        # Pay the first-call costs (kernel build, allocator growth) before
        # the socket opens, once per dispatch size.
        for b in sorted(set(buckets or [model.batch_size])):
            zeros = np.zeros(
                (b, model.canvas, model.canvas, model.channels), np.uint8)
            model.fn(zeros)
        state["warm"] = True

    max_queue_rows = args.max_queue_rows
    if max_queue_rows is None and model.batch_size is not None:
        max_queue_rows = 32 * model.batch_size
    if max_queue_rows == 0:
        max_queue_rows = None
    deadline_ms = args.deadline_ms or None
    batcher = MicroBatcher(model.fn, model.batch_size, model.canvas,
                           model.channels, max_delay_ms=args.max_delay_ms,
                           buckets=buckets, max_queue_rows=max_queue_rows,
                           deadline_ms=deadline_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet per-request stderr spam
            pass

        def _send(self, code, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj, headers=()):
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "warm": state["warm"],
                                 "kind": model.kind})
            elif self.path == "/info":
                self._json(200, {
                    "kind": model.kind,
                    "input": [model.batch_size, model.canvas, model.canvas,
                              model.channels],
                    "max_delay_ms": args.max_delay_ms,
                    "max_queue_rows": batcher.max_queue_rows,
                    "deadline_ms": deadline_ms,
                    **model.meta,
                })
            elif self.path == "/stats":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            if n > args.max_request_mb * 1024 * 1024:
                self._json(413, {"error": f"request body {n} bytes exceeds "
                                          f"--max_request_mb "
                                          f"{args.max_request_mb}"})
                return
            body = self.rfile.read(n)
            try:
                if self.path == "/predict":
                    arr = np.load(io.BytesIO(body), allow_pickle=False)
                    out = batcher.submit(np.ascontiguousarray(arr))
                    if "application/json" in self.headers.get("Accept", ""):
                        self._json(200, {"output": out.tolist()})
                    else:
                        buf = io.BytesIO()
                        np.save(buf, out)
                        self._send(200, buf.getvalue(),
                                   "application/octet-stream")
                elif self.path == "/predict_image":
                    if model.channels != 3:
                        self._json(400, {"error": "image endpoint serves "
                                                  "3-channel models only"})
                        return
                    from PIL import Image

                    with Image.open(io.BytesIO(body)) as im:
                        arr = np.asarray(im.convert("RGB").resize(
                            (model.canvas, model.canvas), Image.BICUBIC))
                    out = batcher.submit(arr[None].astype(np.uint8))
                    self._json(200, {"output": out[0].tolist()})
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            except (ValueError, OSError, EOFError) as e:
                # malformed npy/image bodies (np.load raises EOFError on an
                # empty buffer, PIL raises UnidentifiedImageError <: OSError)
                self._json(400, {"error": str(e)})
            except QueueFullError as e:
                self._json(429, {"error": str(e)}, [("Retry-After", "1")])
            except DeadlineExceededError as e:
                self._json(504, {"error": str(e)})
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — last resort: answer 500
                # rather than kill the handler thread mid-response
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    log(f"serving {model.kind} model on "
        f"http://{args.host}:{server.server_address[1]} "
        f"(batch {model.batch_size}, canvas {model.canvas}, "
        f"window {args.max_delay_ms} ms, device {model.meta.get('device')})")
    return server, batcher


def main(args) -> dict:
    import signal

    server, batcher = build_app(args)

    def handle(_sig, _frm):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    try:
        server.serve_forever()
    finally:
        batcher.close()
        server.server_close()
    return {"stopped": True}


if __name__ == "__main__":
    main(get_args_parser().parse_args())
