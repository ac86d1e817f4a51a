"""Persistent binarization server: the port's serving surface.

The JAX package's server (lecturemath_tpu/pipeline/server.py) keeps its
model resident and jit-warm; the port keeps the same contract on the card:

  * the model stays RESIDENT: the checkpoint loads once, and every batch
    bucket is made ready before the first request;
  * requests are MICRO-BATCHED: concurrent requests arriving within a short
    window ride one device dispatch, and each caller gets its own frame
    back;
  * inputs are resized host-side (``utils/image.py resize_area``, equal to
    cv2 INTER_AREA) to ONE fixed model bucket, and each micro-batch is
    padded to a power-of-two batch bucket (1, 2, 4, ..., max_batch);
    outputs come back at the caller's own resolution (nearest);
  * on the card each batch bucket is ONE CUDA graph of
    ``Binarizer.packed_fn``, captured at warm-up: from a static uint8 input
    it runs ``prepare_images``, ``pad_to_multiple``, the bf16
    channels_last forward with kernel K2 on the four head convs, and
    kernel K1 into a static packed output. A dispatch stages the frames in
    pinned memory, copies them in, replays the graph, and fetches the
    packed bits (1 bit a pixel) through the bounded ``Binarizer.fetch``;
    the host unpacks them. The buckets of one model share one graph memory
    pool, captured largest first;
  * on the CPU (the caller asked for it) the same functions run eagerly,
    and ``graphs=False`` runs them eagerly on the card (to time the
    difference); either way ``Binarizer.dispatch`` makes the upload. A
    failed capture raises at warm-up: the card never falls back to eager
    launches unasked.

Run via ``python -m lecturemath_tpu_torch.cli.serve <config> [-port N]``;
programmatic use via BinarizeService. The HTTP contract:

  POST /binarize     image body (PNG of any kind, decoded without OpenCV;
                     JPEG and other formats only where OpenCV is
                     installed, else 400) -> binary PNG (ink=0 on 255, the model's
                     raw polarity; ``?invert=1`` flips to ink=255 — the
                     stage-01 artifact polarity)
  POST /reload       JSON {"checkpoint": optional path} -> hot-swap the
                     checkpoint WITHOUT dropping traffic: the new model
                     loads and captures every batch bucket off to the side,
                     then swaps in atomically between dispatches
  GET  /healthz      liveness + device + model bucket
  GET  /stats        request/batch counters, mean batch size, latency,
                     graph replays and the kernel launches they made
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from http.server import ThreadingHTTPServer
from queue import Empty, Queue
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core.backend_probe import BackendUnavailable
from ..models.fcn_lecturenet import unpack_bits_host
from ..ops.conv7 import conv_same_nhwc
from ..ops.postprocess import threshold_pack
from ..utils.image import resize_area, resize_nearest
from ..utils.png import PNGFormatError, decode_png_color, encode_png
from .binarize import _BYTES_PER_PIXEL, Binarizer, resolve_model_size

# the kernel wrappers a serving graph holds, by their launch counters
_KERNELS = {"threshold_pack": threshold_pack,
            "conv_same_nhwc": conv_same_nhwc}


def _launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


class _WorkItem:
    __slots__ = ("frame", "event", "result", "error")

    def __init__(self, frame: np.ndarray):
        self.frame = frame
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class _BucketGraph:
    """One batch bucket's CUDA graph: a static uint8 input on the card, the
    static packed output the graph writes, and pinned staging memory."""

    def __init__(self, fn, input_shape: Tuple[int, ...],
                 device: torch.device, pool):
        self.static_in = torch.zeros(input_shape, dtype=torch.uint8,
                                     device=device)
        self.pinned = torch.empty(input_shape, dtype=torch.uint8,
                                  pin_memory=True)
        # first use of every kernel (nvcc's build, the library load,
        # cuDNN's choice) eagerly on a side stream, as PyTorch asks before
        # a capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a dispatch of the model being replaced may run on
        # another thread while this one captures
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.static_out = fn(self.static_in)
        # kernel launches one replay makes (the wrappers count at capture)
        self.launches = {name: count - before[name]
                         for name, count in _launch_counts().items()}

    def run(self, frames: np.ndarray) -> torch.Tensor:
        """Stage ``frames``, copy them in and replay, on the current
        stream. The returned static output is overwritten by the next
        replay: the caller fetches it first."""
        self.pinned.numpy()[...] = frames
        self.static_in.copy_(self.pinned, non_blocking=True)
        self.graph.replay()
        return self.static_out


class _Resident:
    """A binarizer as the service dispatches it: on the card unless
    ``graphs`` is False, one CUDA graph per batch bucket, the buckets
    sharing one memory pool. Dispatches run on the resident's own
    stream."""

    def __init__(self, binarizer: Binarizer, graphs: bool,
                 capture_lock: threading.Lock):
        self.binarizer = binarizer
        device = binarizer.device
        self.graphs_enabled = bool(graphs and device.type == "cuda")
        self.graphs: Dict[int, _BucketGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle() if self.graphs_enabled
                     else None)
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.capture_s = 0.0
        self._capture_lock = capture_lock

    def stream_context(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def graph(self, input_shape: Tuple[int, ...]) -> _BucketGraph:
        """The bucket's graph, captured at its first use (warm-up captures
        every bucket before the first request)."""
        bucket = input_shape[0]
        graph = self.graphs.get(bucket)
        if graph is None:
            with self._capture_lock:
                graph = self.graphs.get(bucket)
                if graph is None:
                    t0 = time.perf_counter()
                    graph = _BucketGraph(self.binarizer.packed_fn,
                                         input_shape, self.binarizer.device,
                                         self.pool)
                    self.capture_s += time.perf_counter() - t0
                    self.graphs[bucket] = graph
        return graph


class BinarizeService:
    """Thread-safe micro-batching front end over a resident Binarizer."""

    def __init__(self, binarizer: Binarizer,
                 model_size: Tuple[int, int] = (960, 540),
                 max_batch: int = 8, batch_window_ms: float = 5.0,
                 warmup: bool = True, binarizer_factory=None,
                 request_timeout_s: Optional[float] = None,
                 graphs: bool = True):
        """``graphs``: on the card, replay one CUDA graph per batch bucket
        (default); False launches the same kernels eagerly. Ignored on the
        CPU, which always runs eagerly."""
        self.binarizer = binarizer
        # optional callable (checkpoint_path_or_None) -> Binarizer, used
        # by reload_checkpoint to rebuild with fresh weights
        self._factory = binarizer_factory
        self.use_graphs = bool(graphs)
        # (width, height) the model sees — same halving rule as stage 01
        self.model_size = resolve_model_size(*model_size)
        self.max_batch = max(1, int(max_batch))
        # micro-batches PAD to one of a few power-of-two buckets (1, 2, 4,
        # ..., max_batch): one CUDA graph each, all captured at warm-up
        self.batch_buckets = []
        bucket = 1
        while bucket < self.max_batch:
            self.batch_buckets.append(bucket)
            bucket *= 2
        self.batch_buckets.append(self.max_batch)
        self.batch_window_s = float(batch_window_ms) / 1000.0
        # per-request backstop AND the stuck-dispatch threshold: a device
        # that dies mid-serving leaves the worker hung inside a dispatch —
        # callers must not each wait the full backstop
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else os.environ.get("LM_SERVE_TIMEOUT_S", "600"))
        self._dispatch_started: Optional[float] = None
        # latched when a dispatch dies of backend death (the bounded
        # fetch raising BackendUnavailable): without the latch, health
        # would flap back to ok between failed dispatches on a dead
        # backend. Cleared by the next SUCCESSFUL dispatch or reload.
        self._backend_dead: Optional[str] = None
        self._queue: "Queue[Optional[_WorkItem]]" = Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._capture_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "frames": 0,
                       "last_batch": 0, "last_latency_ms": 0.0,
                       "reloads": 0, "graph_replays": 0,
                       "started": time.time()}
        # kernel launches made by graph replays (the wrappers' own counters
        # tick only when a graph is captured)
        self.replay_launches = {name: 0 for name in _KERNELS}
        # _active: ONE attribute so the worker reads a consistent resident
        # and reload swaps it atomically
        self._active = self._prepare(binarizer)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        if warmup:
            self._warm(self._active)

    def _prepare(self, binarizer: Binarizer) -> _Resident:
        """Fit a binarizer's uploads to this service's bucket and wrap it
        for dispatch."""
        binarizer.fit_upload(self.model_size)
        return _Resident(binarizer, self.use_graphs, self._capture_lock)

    def _input_shape(self, active: _Resident, bucket: int) -> Tuple[int, ...]:
        width, height = self.model_size
        if active.binarizer.upload_format == "yuv420":
            return (bucket, height * 3 // 2, width)
        return (bucket, height, width, 3)

    def graph_pool_estimate(self) -> int:
        """Device bytes the largest bucket's graph is expected to hold: the
        stage-01 activation budget per padded model pixel."""
        width, height = self.model_size
        padded = (-(-width // 32) * 32) * (-(-height // 32) * 32)
        return self.max_batch * padded * _BYTES_PER_PIXEL

    def _warm(self, active: _Resident) -> None:
        """Make every bucket ready before the first caller sees it: on the
        card capture each bucket's graph, largest first (the pool takes the
        largest bucket's size once), then dispatch zeros through each."""
        if active.graphs_enabled:
            device = active.binarizer.device
            free, _ = torch.cuda.mem_get_info(device)
            if free < self.graph_pool_estimate():
                raise RuntimeError(
                    f"not enough free device memory to capture the serving "
                    f"graphs: {free} B free, about "
                    f"{self.graph_pool_estimate()} B needed for batch "
                    f"{self.max_batch} at {self.model_size[0]}x"
                    f"{self.model_size[1]}")
            with active.stream_context():
                for bucket in sorted(self.batch_buckets, reverse=True):
                    active.graph(self._input_shape(active, bucket))
        width, height = self.model_size
        for bucket in self.batch_buckets:
            frames = np.zeros((bucket, height, width, 3), np.uint8)
            self._dispatch(frames, active)

    # ------------------------------------------------------------- public

    def binarize_rgb(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB [H, W, 3] -> uint8 binary [H, W] at the input's
        resolution, ink=0 on 255 (model polarity). Blocking; safe to call
        from many threads — concurrent calls share device dispatches."""
        height, width = rgb.shape[:2]
        bucket_w, bucket_h = self.model_size
        if (width, height) != (bucket_w, bucket_h):
            resized = resize_area(rgb, (bucket_w, bucket_h))
        else:
            resized = rgb
        if self._closed:
            raise RuntimeError("BinarizeService is closed")
        if self._backend_dead is not None:
            raise RuntimeError(
                f"serving unhealthy: {self._backend_dead}")
        stuck_s = self.dispatch_stuck_s()
        if stuck_s > self.request_timeout_s:
            # the worker is wedged inside a device dispatch (device lost
            # mid-serving) — fail NOW instead of queuing every caller into
            # its own full-timeout wait
            raise RuntimeError(
                f"serving unhealthy: device dispatch stuck for "
                f"{stuck_s:.0f} s (device lost?)")
        item = _WorkItem(resized)
        self._queue.put(item)
        # re-check AFTER the put: close() may have set the flag and
        # drained the queue between our check and our put, in which case
        # nobody will ever serve this item — fail it here instead of
        # letting the caller block into the 600 s backstop
        if self._closed and not self._worker.is_alive() \
                and not item.event.is_set():
            item.error = RuntimeError("BinarizeService is closed")
            item.event.set()
        # backstop so a dying worker can never hang callers
        if not item.event.wait(timeout=self.request_timeout_s):
            raise RuntimeError(f"binarize request timed out "
                               f"({self.request_timeout_s:.0f} s)")
        if item.error is not None:
            raise item.error
        binary = item.result
        if binary.shape != (height, width):
            binary = resize_nearest(binary, (width, height))
        return binary

    def reload_checkpoint(self, checkpoint: Optional[str] = None) -> dict:
        """Hot-swap the model weights without dropping traffic: build a
        fresh Binarizer via the configured factory, capture and warm every
        batch bucket through it (off to the side while the current model
        keeps serving), then swap it in atomically between dispatches; the
        old model's graphs and pool are released with it. Serialized:
        concurrent reloads queue behind each other."""
        if self._closed:
            raise RuntimeError("BinarizeService is closed")
        if self._factory is None:
            raise RuntimeError(
                "no binarizer_factory configured — construct "
                "BinarizeService(..., binarizer_factory=...) to enable "
                "checkpoint reloads")
        with self._reload_lock:
            new_binarizer = self._factory(checkpoint)
            active = self._prepare(new_binarizer)
            self._warm(active)
            self._active = active
            self.binarizer = new_binarizer
            self._backend_dead = None   # warm succeeded: backend alive
        with self._stats_lock:
            self._stats["reloads"] += 1
        return {"ok": True, "checkpoint": checkpoint}

    def dispatch_stuck_s(self) -> float:
        """Seconds the worker has been inside the CURRENT device dispatch
        (0.0 when idle/batching). Grows without bound when the device
        hangs mid-dispatch — the health signal."""
        started = self._dispatch_started
        return time.monotonic() - started if started is not None else 0.0

    def health(self) -> dict:
        stuck_s = self.dispatch_stuck_s()
        return {"ok": (not self._closed
                       and stuck_s <= self.request_timeout_s
                       and self._backend_dead is None),
                "dispatch_stuck_s": round(stuck_s, 1),
                "backend_dead": self._backend_dead,
                "closed": self._closed}

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
            out["kernel_launches"] = dict(self.replay_launches)
        out["uptime_s"] = round(time.time() - out.pop("started"), 1)
        out["mean_batch"] = (round(out["frames"] / out["batches"], 2)
                             if out["batches"] else 0.0)
        return out

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=30)
        # error out any straggler enqueued between the flag and the drain
        self._fail_pending()
        if self._worker.is_alive():
            # the drain may have swallowed the worker's re-queued
            # shutdown sentinel (close during a long batch) — put one
            # back so the worker exits instead of blocking forever
            self._queue.put(None)

    def _fail_pending(self) -> None:
        """Error-out every queued request (shutdown paths); shutdown
        sentinels (None) are left out of the failure set."""
        while True:
            try:
                item = self._queue.get_nowait()
            except Empty:
                return
            if item is not None and not item.event.is_set():
                item.error = RuntimeError("BinarizeService closed")
                item.event.set()

    # ------------------------------------------------------------- worker

    def _dispatch(self, frames: np.ndarray, active=None) -> np.ndarray:
        """One device dispatch: uint8 RGB [B, H, W, 3] -> binary
        [B, H, W] ink=0/bg=255, via the bit-packed download. ``active``
        pins a resident (reload warms the incoming one while the worker
        serves the current)."""
        active = active if active is not None else self._active
        binarizer = active.binarizer
        with active.stream_context():
            if active.graphs_enabled:
                graph = active.graph(self._input_shape(active, len(frames)))
                packed = binarizer.dispatch(frames, graph.run)
            else:
                packed = binarizer.dispatch(frames)
            host = binarizer.fetch(packed)
        if active.graphs_enabled:
            with self._stats_lock:
                self._stats["graph_replays"] += 1
                for name, count in graph.launches.items():
                    self.replay_launches[name] += count
        return unpack_bits_host(host, self.model_size[0])

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                # closing: anything still queued will never be served
                self._fail_pending()
                return
            batch = [item]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    extra = self._queue.get(timeout=remaining)
                except Empty:
                    break
                if extra is None:   # close() while batching: finish batch
                    self._queue.put(None)
                    break
                batch.append(extra)
            start = time.monotonic()
            self._dispatch_started = start
            try:
                # pad to the next batch bucket: only the captured bucket
                # shapes ever reach the card
                bucket = next(b for b in self.batch_buckets
                              if b >= len(batch))
                frames = np.stack([entry.frame for entry in batch]
                                  + [batch[0].frame] * (bucket - len(batch)))
                binaries = self._dispatch(frames)
                for entry, binary in zip(batch, binaries):
                    entry.result = np.asarray(binary)
                self._backend_dead = None   # proof of life: un-latch
            except Exception as err:  # noqa: BLE001 — deliver to callers
                if isinstance(err, BackendUnavailable):
                    self._backend_dead = str(err)
                for entry in batch:
                    entry.error = err
            finally:
                self._dispatch_started = None
            # stats BEFORE waking callers: a caller that returns and reads
            # stats() must see its own request counted
            latency_ms = (time.monotonic() - start) * 1e3
            with self._stats_lock:
                self._stats["requests"] += len(batch)
                self._stats["batches"] += 1
                self._stats["frames"] += len(batch)
                self._stats["last_batch"] = len(batch)
                self._stats["last_latency_ms"] = round(latency_ms, 1)
            for entry in batch:
                entry.event.set()


# --------------------------------------------------------------- HTTP UI

# leading bytes of the image formats a client may send
_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"),
          (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"))


def _opencv():
    """cv2, where it is installed (the port does not require it)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_image(payload: bytes) -> np.ndarray:
    """Request body -> uint8 RGB [H, W, 3], as ``cv2.imdecode(payload,
    cv2.IMREAD_COLOR)`` gives it. A PNG of any kind decodes without
    OpenCV (``utils/png.py decode_png_color``); JPEG and the other formats
    need OpenCV, and where it is not installed they are refused. Raises
    ValueError naming what could not be decoded."""
    kind = next((name for magic, name in _MAGIC if payload.startswith(magic)),
                None)
    if kind == "PNG":
        try:
            return decode_png_color(payload)
        except PNGFormatError as err:
            raise ValueError(f"PNG body not decodable: {err}") from None
    cv2 = _opencv()
    if cv2 is None:
        if kind is None:
            raise ValueError("body is not a decodable image")
        raise ValueError(f"a {kind} body needs OpenCV to decode, and it is "
                         f"not installed; send a PNG")
    image = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
    if image is None:
        raise ValueError("body is not a decodable image")
    return np.ascontiguousarray(image[:, :, ::-1])


def make_handler(service: BinarizeService):
    import json
    from http.server import BaseHTTPRequestHandler

    device = service.binarizer.device
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, content_type: str = "application/json",
                  status: int = 200):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, status: int = 200):
            self._send(json.dumps(obj).encode(), status=status)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                health = service.health()
                self._json({**health, "device": device.type,
                            "device_name": device_name,
                            "graphs": service._active.graphs_enabled,
                            "model_size": list(service.model_size),
                            "max_batch": service.max_batch},
                           status=200 if health["ok"] else 503)
            elif self.path.startswith("/stats"):
                self._json(service.stats())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path.startswith("/reload"):
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length)
                try:
                    body = json.loads(payload or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    self._json(service.reload_checkpoint(
                        body.get("checkpoint")))
                except Exception as err:  # noqa: BLE001 — a failed
                    # reload (bad JSON, bad path, corrupt checkpoint)
                    # must answer 400, never drop the connection; the
                    # old model keeps serving either way
                    self._json({"ok": False, "error": str(err)},
                               status=400)
                return
            if not self.path.startswith("/binarize"):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            payload = self.rfile.read(length)
            try:
                image = decode_image(payload)
            except ValueError as err:
                self._json({"ok": False, "error": str(err)}, status=400)
                return
            try:
                binary = service.binarize_rgb(image)
            except Exception as err:  # noqa: BLE001 — service errors
                # (closing, dispatch failure, timeout) must answer 503,
                # never drop the connection
                self._json({"ok": False, "error": str(err)}, status=503)
                return
            if "invert=1" in self.path:
                binary = 255 - binary
            self._send(encode_png(binary), "image/png")

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 makes the kernel drop the
    # connections of a larger burst of clients, which retry only after 1 s
    # and 3 s (32 concurrent clients saw a 3.6 s p99 on the card)
    request_queue_size = 128


def serve(service: BinarizeService, port: int = 0):
    """Start the serving HTTP front end; returns the bound HTTPServer —
    call serve_forever() (blocking) or run it in a thread (tests)."""
    # the PNG decoder's native unfilter, built and loaded before the first
    # request rather than inside it
    native.get_lib()
    return _HTTPServer(("127.0.0.1", port), make_handler(service))
