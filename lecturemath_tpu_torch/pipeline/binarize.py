"""Stage 01 — batched FCN binarization of sampled lecture frames on the card.

Frames stream in fixed batches through FCNLectureNet (bf16, channels_last,
BatchNorm folded) and kernel K1, which leaves one packed bitmap per frame on
the device. Each bitmap is copied into reused pinned host memory on a side
stream, so the copy of batch k overlaps the compute of batch k+1, and the
host unpacks it when the copy's CUDA event has fired.

With a mesh (``-mesh D``), each batch splits by rows over one replica of
the model per local card, and across the processes of a world, each
process receiving every frame (parallel/inference.py); the output is the
same as without one. On a model axis (``-mesh DxM``) each data position's
M devices hold the channel shards of the model, as the JAX package's
Binarizer lays them out (parallel/model_axis.py); the output equals the
meshless one up to the summation order of the sharded layers.

Polarity: the raw model output follows the training GT (ink=0 on a 255
background); the stage artifact is inverted to ink=255 exactly like the
reference worker (FCN_lecturenet_binarizer.py:54) so downstream CC labeling
sees foreground ink as nonzero.
"""

from __future__ import annotations

import collections
import itertools
import os
import queue
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.backend_probe import BackendUnavailable, call_with_deadline
from ..core.config import Config
from ..core.device import resolve_device
from ..core.timing import span
from ..models.convert import load_checkpoint
from ..models.fcn_lecturenet import (FCNConfig, FCNLectureNet, fold_model,
                                     init_weights, rgb_to_yuv420_host,
                                     unpack_bits_host)
from ..parallel.inference import group_binarizers, pad_rows, sharded_forward
from ..parallel.mesh import check_mesh, process_count, shard_params
from ..utils.image import halve_lanczos, resize_area, resize_nearest
from .video import VideoFrameSource, batched

MAX_BATCH = 96
# batches in flight on the device beyond the one being drained
PIPELINE_DEPTH = 2
# device bytes per model pixel for a batch: the production-width forward in
# bf16 keeps about 450 B/px of activations live at its peak (up_1's skip,
# deconv and concat at full resolution), plus the f32 input and the
# allocator's slack
_BYTES_PER_PIXEL = 768
# the CPU has no memory query: the JAX package's pixel budget for a local chip
_CPU_PIXEL_BUDGET = 48_000_000


def resolve_model_size(width: int, height: int,
                       max_pixels: int = 2_500_000) -> Tuple[int, int]:
    """Halve dimensions while the pixel count exceeds the cap (reference:
    FCN_lecturenet.py:434-437). Returns the (width, height) the model sees."""
    while width * height > max_pixels:
        width = int(width / 2)
        height = int(height / 2)
    return width, height


def default_batch_size(width: int, height: int, device: torch.device,
                       max_batch: int = MAX_BATCH) -> int:
    """Frames per batch: on the card, what fits in 60% of its free memory
    at ``_BYTES_PER_PIXEL``; on the CPU, a fixed pixel budget. Capped at
    ``max_batch`` and rounded down to a multiple of 8."""
    pixels = max(1, width * height)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        batch = int(0.6 * free) // (pixels * _BYTES_PER_PIXEL)
    else:
        batch = _CPU_PIXEL_BUDGET // pixels
    batch = max(1, min(max_batch, batch))
    if batch >= 8:
        batch -= batch % 8
    return batch


def _start_host_copy(tensor: torch.Tensor):
    """Queue a copy of ``tensor`` into new pinned host memory on the current
    stream; returns (host tensor, CUDA event recorded after the copy). A
    CPU tensor is its own host copy (event None)."""
    if tensor.device.type != "cuda":
        return tensor, None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensor.device))
    return host, done


def _wait_host_copy(host: torch.Tensor, done) -> np.ndarray:
    """Block until the copy of ``_start_host_copy`` has landed (the event
    wait releases the GIL); returns it as a numpy array."""
    if done is not None:
        done.synchronize()
    return host.numpy()


class _HostCopies:
    """Device -> host copies of batch results into reused pinned buffers.

    ``start`` queues the copy on a side stream behind the work already on
    the current stream and records a CUDA event; ``wait`` blocks on that
    event only (not on the whole device); ``release`` hands the buffer back
    once the consumer has unpacked it, and ``start`` blocks while every
    buffer is still held. On the CPU the result is the host array."""

    def __init__(self, device: torch.device, n_buffers: int):
        self.device = device
        self._n_buffers = n_buffers
        self._free: "queue.Queue[torch.Tensor]" = queue.Queue()
        self._spec = None
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def start(self, result: torch.Tensor):
        if self._stream is None:
            return result, None
        spec = (tuple(result.shape), result.dtype)
        if self._spec is None:
            self._spec = spec
            for _ in range(self._n_buffers):
                self._free.put(torch.empty(spec[0], dtype=spec[1],
                                           pin_memory=True))
        elif spec != self._spec:
            raise ValueError(f"batch result changed shape: {spec} after "
                             f"{self._spec}")
        buffer = self._free.get()
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            buffer.copy_(result, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the allocator must not reuse ``result`` before the copy has read it
        result.record_stream(self._stream)
        return buffer, done

    @staticmethod
    def wait(handle) -> np.ndarray:
        buffer, done = handle
        if done is not None:
            done.synchronize()
        return buffer.numpy()

    def release(self, handle) -> None:
        buffer, done = handle
        if done is not None:
            self._free.put(buffer)


class _Drainer:
    """The drain of ``Binarizer.stream_source``: keeps up to ``depth``
    batches in flight beyond the one being drained, and hands back their
    ``drain_fn`` results in batch order.

    ``threaded``: the drain runs on the ``lm-stream-drain`` thread, which
    waits for batch k+1's copy event and unpacks it while the consumer does
    its host work on batch k (CC tracking, PNG encode;
    ``torch.cuda.Event.synchronize`` releases the GIL); the consumer's
    blocked time on the results is the span ``stage01.wait``, tagged with
    the batch number. Otherwise each drain runs inline when the in-flight
    bound forces it. Both give the same results in the same order."""

    _DONE = object()

    def __init__(self, drain_fn, depth: int, threaded: bool):
        self._drain_fn = drain_fn
        self._depth = depth
        self._pending = collections.deque()   # inline: entries not drained
        self._inflight = 0
        self._stop = False
        self._taken = 0
        self._thread = None
        if threaded:
            import threading

            self._in = queue.Queue()
            self._out = queue.Queue(maxsize=depth + 2)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="lm-stream-drain")
            self._thread.start()

    def _run(self):
        while True:
            entry = self._in.get()
            if entry is self._DONE or self._stop:
                self._put(self._DONE)
                return
            try:
                out = self._drain_fn(entry)
            except BaseException as exc:  # noqa: BLE001 — relayed to consumer
                self._put(("err", exc))
                return
            if not self._put(("ok", out)):
                return

    def _put(self, item) -> bool:
        """Bounded put that gives up if the consumer abandoned the stream
        (close() sets _stop) — never leaves this thread blocked forever."""
        while not self._stop:
            try:
                self._out.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _take(self):
        self._inflight -= 1
        if self._thread is None:
            return self._drain_fn(self._pending.popleft())
        with span("stage01.wait", tag=self._taken):
            item = self._out.get()
        self._taken += 1
        if item is self._DONE:
            raise RuntimeError("stream drain thread exited early")
        kind, val = item
        if kind == "err":
            self._stop = True
            raise val
        return val

    def push(self, entry):
        """Queue one in-flight entry; returns [result] when the in-flight
        bound forces a drain."""
        if self._thread is None:
            self._pending.append(entry)
        else:
            self._in.put(entry)
        self._inflight += 1
        if self._inflight > self._depth:
            return [self._take()]
        return []

    def finish(self):
        """Yield the remaining in-flight results in order."""
        if self._thread is not None:
            self._in.put(self._DONE)
        while self._inflight:
            yield self._take()

    def close(self):
        """Abandonment path (consumer broke out of the generator): unblock
        and discard; the daemon thread exits on its next queue interaction."""
        if self._thread is None:
            return
        self._stop = True
        self._in.put(self._DONE)
        try:
            while True:
                self._out.get_nowait()
        except queue.Empty:
            pass


class Binarizer:
    """Batched binarizer for a stream of RGB frames, on ``cuda`` unless
    ``device='cpu'``. It alone decides how a batch reaches the device and
    comes back: ``dispatch`` (host batch -> packed bits on the device, the
    batch function ``packed_fn``), ``fit_upload`` (the upload format for a
    frame size), ``fetch`` (the bounded copy back) and ``full_outputs``
    (binary, text mask and reconstruction)."""

    def __init__(self, model: FCNLectureNet,
                 batch_size: Optional[int] = None, threshold: int = 128,
                 mesh=None, upload_format: str = "auto",
                 downscale: str = "host", downscale_filter: str = "lanczos",
                 max_model_pixels: int = 2_500_000,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[torch.dtype] = None):
        """``model`` carries the weights (f32 preferred: a model whose
        BatchNorms are not folded yet is folded in f32, by
        models.fcn_lecturenet.fold_model, before the cast to ``dtype``; None
        keeps the model's dtype).

        ``upload_format``: 'rgb' ships raw uint8 RGB to the device;
        'yuv420' converts to I420 planes on host and reconstructs RGB on
        device (half the upload bytes; differs from the RGB path only by
        BT.601 chroma rounding). 'auto' is 'rgb': a card on PCIe is not
        bound by the upload. Config: UPLOAD_FORMAT.

        ``downscale``: where the >2.5MP halving (resolve_model_size) runs.
        'host' (default) halves before upload with the reference-parity PIL
        LANCZOS filter; 'device' uploads full-res frames and box-halves on
        the card (device_halve; stream only). Config: DOWNSCALE_PLACEMENT.

        ``downscale_filter``: host filter — 'lanczos' (reference parity,
        FCN_lecturenet.py:436) or 'area' (cv2 INTER_AREA). Config:
        DOWNSCALE_FILTER.

        ``max_model_pixels``: the halving cap (reference: 2.5 MP,
        FCN_lecturenet.py:434). Config: BINARIZATION_MAX_PIXELS.

        ``mesh`` (parallel/mesh.py ``make_mesh``): one replica of the model
        per local device of the mesh, which replaces ``device``; each
        batch's rows split over them and over the world's processes (every
        process passes the same frames and receives all of them). On a
        ``DxM`` mesh with M > 1 each data position's M devices hold the
        model's channel shards instead (``shard_params``, after the fold).
        ``batch_size`` rounds up to a multiple of the data axis only, a
        ragged batch is padded with its last frame and cropped back."""
        if mesh is not None:
            check_mesh(mesh)
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"({mesh.device.type})")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        if not model.fold_bn:
            model = fold_model(model)
        model = model.to(device=self.device, dtype=dtype or model.dtype,
                         memory_format=torch.channels_last).eval()
        self._replicas = (shard_params(mesh, model) if mesh is not None
                          else [model])
        for replica in self._replicas:
            device_of = replica.mid_block[0].weight.device
            if device_of.type == "cuda" and not replica.plain:
                # K2's packed weights, once per replica on its card
                with torch.cuda.device(device_of):
                    replica.pack_heads()
        self.model = model
        self.mesh = mesh
        if mesh is not None and batch_size is not None:
            data_size = mesh.shape["data"]
            batch_size = -(-batch_size // data_size) * data_size
        self.batch_size = batch_size
        self.threshold = threshold
        self._binarize_fns = self._group_fns(packed=False)
        # the binary output alone, of every model group
        self._binary_fns = [lambda x, fn=fn: fn(x)[0]
                            for fn in self._binarize_fns]
        if upload_format == "auto":
            upload_format = "rgb"
        if upload_format not in ("rgb", "yuv420"):
            raise ValueError(f"unknown upload format: {upload_format!r}")
        self.upload_format = upload_format
        if downscale not in ("host", "device"):
            raise ValueError(f"unknown downscale placement: {downscale!r}")
        if downscale_filter not in ("lanczos", "area"):
            raise ValueError(f"unknown downscale filter: {downscale_filter!r}")
        self.downscale = downscale
        self.downscale_filter = downscale_filter
        self.max_model_pixels = max_model_pixels
        self._make_packed(upload_format, 0)

    def _group_fns(self, **kwargs):
        """``group_binarizers`` of every local model group: one replica
        each on a data-only mesh, channel shards on a model axis."""
        return group_binarizers(self.mesh, self._replicas, "channel",
                                threshold=self.threshold, **kwargs)

    def _make_packed(self, input_format: str, pre_halvings: int) -> None:
        """The packed batch function of every model group
        (``packed_fns``; ``packed_fn`` is the first's)."""
        self.packed_fns = self._group_fns(packed=True,
                                          input_format=input_format,
                                          pre_halvings=pre_halvings)
        self._packed_key = (input_format, pre_halvings)

    @property
    def packed_fn(self):
        """uint8 frames in the upload format, on the device -> the packed
        binary bitmap [B, h, ceil(w/8)] (kernel K1 on the card)."""
        return self.packed_fns[0]

    def fit_upload(self, size: Tuple[int, int], pre_halvings: int = 0) -> None:
        """Make ``packed_fn`` take uploads of ``size`` (width, height),
        box-halved ``pre_halvings`` times on the device: I420 needs an even
        width and a height divisible by 4 there, else the upload is RGB."""
        if self.upload_format == "yuv420" and (size[0] % 2 or size[1] % 4):
            self.upload_format = "rgb"
        if self._packed_key != (self.upload_format, pre_halvings):
            self._make_packed(self.upload_format, pre_halvings)

    def _run(self, fns, frames: np.ndarray) -> torch.Tensor:
        """The batch function ``fns[g]`` of model group g over ``frames``
        (rows a multiple of the data axis under a mesh): the output of
        every row, on ``self.device``."""
        if self.mesh is None:
            return fns[0](self._to_device(frames))
        return sharded_forward(self.mesh, fns, frames)

    @classmethod
    def from_config(cls, config: Config, allow_random: bool = False,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: int = 0, **kwargs) -> "Binarizer":
        """Load the model named by BINARIZATION_FCN_LECTURENET_DIR/FILENAME
        (a torch ``.dat``/``.pth`` state dict, or a JAX-package ``.msgpack``).
        With ``allow_random`` and no checkpoint, the weights are a random
        init from ``torch.Generator().manual_seed(seed)``."""
        device = resolve_device(device)
        net_config = FCNConfig.from_config(config)
        model = FCNLectureNet(net_config)
        kwargs.setdefault("upload_format",
                          config.get_str("UPLOAD_FORMAT", "auto"))
        kwargs.setdefault("downscale",
                          config.get_str("DOWNSCALE_PLACEMENT", "host"))
        kwargs.setdefault("downscale_filter",
                          config.get_str("DOWNSCALE_FILTER", "lanczos"))
        kwargs.setdefault("max_model_pixels",
                          config.get_int("BINARIZATION_MAX_PIXELS",
                                         2_500_000))

        model_dir = config.get_str("BINARIZATION_FCN_LECTURENET_DIR", "models")
        model_file = config.get_str("BINARIZATION_FCN_LECTURENET_FILENAME",
                                    "LectureNet_model_BIN.dat")
        # the reference resolves the model dir under OUTPUT_PATH
        # (pre_ST3D_v3.0_01_binarize.py:24-26); an absolute model dir wins
        # either way because os.path.join discards earlier components then
        output_path = config.get_str("OUTPUT_PATH", "")
        candidates = [os.path.join(output_path, model_dir, model_file),
                      os.path.join(model_dir, model_file)]
        path = next((p for p in candidates if os.path.exists(p)),
                    candidates[0])

        if os.path.exists(path):
            model.load_state_dict(load_checkpoint(path), strict=True)
        elif allow_random:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            raise FileNotFoundError(f"model checkpoint not found: {path}")

        return cls(model, device=device, dtype=dtype, **kwargs)

    # ------------------------------------------------------------ inference

    def _to_device(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def dispatch(self, frames: np.ndarray, run=None) -> torch.Tensor:
        """uint8 RGB [B, H, W, 3] on the host, at the size ``fit_upload``
        was given -> ``packed_fn``'s bitmap of every frame, on
        ``self.device`` (queued, not waited for): converted to I420 on the
        host where the upload format says so, uploaded, run. ``run`` takes
        the host batch in the upload format instead (a CUDA graph of
        ``packed_fn`` that stages and uploads it itself)."""
        if self.upload_format == "yuv420":
            frames = rgb_to_yuv420_host(frames)
        if run is not None:
            return run(frames)
        return self._run(self.packed_fns, frames)

    def fetch(self, tensor: torch.Tensor) -> np.ndarray:
        """Bounded device -> host copy. On the card the copy is queued into
        pinned memory behind a CUDA event, and a daemon thread waits on the
        event with a deadline (LM_FETCH_TIMEOUT_S, default 900 s; <= 0
        waits without one): a card that stops answering mid-run raises an
        actionable error instead of stalling the caller. On the CPU the
        tensor is the host copy."""
        timeout_s = float(os.environ.get("LM_FETCH_TIMEOUT_S", "900"))
        host, done = _start_host_copy(tensor)
        if timeout_s <= 0:
            return _wait_host_copy(host, done)
        try:
            return call_with_deadline(lambda: _wait_host_copy(host, done),
                                      timeout_s, "device fetch")
        except BackendUnavailable:
            raise BackendUnavailable(
                f"device fetch hung for {timeout_s:.0f} s (backend died "
                f"mid-run?) — re-run this stage when the backend recovers, "
                f"or set LM_FETCH_TIMEOUT_S to adjust/disable this "
                f"deadline") from None

    def full_outputs(self, frames: torch.Tensor):
        """uint8 RGB [B, H, W, 3] on the device -> (binary, text mask,
        reconstruction) on the device: uint8 [B, H, W] {0, 255} twice and
        uint8 [B, H, W, 3]."""
        return self._binarize_fns[0](frames)

    def binarize_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 RGB [B, H, W, 3] -> uint8 binary [B, H, W] in the raw model
        polarity (a trained model emits ink=0 on a 255 background)."""
        n = len(frames)
        if self.mesh is not None:
            frames = pad_rows(np.asarray(frames), self.mesh.shape["data"])
        return self.fetch(self._run(self._binary_fns, frames))[:n]

    def stream_source(self, source: VideoFrameSource, frames_limit: int = 0,
                      invert: bool = True):
        """Generator over drained batches: yields (times, indices, frames)
        with up to ``PIPELINE_DEPTH`` batches still in flight on the device.
        Consumers doing host work between batches (CC tracking, PNG encode)
        overlap it with device compute — express wall-clock approaches
        max(host, device) instead of their sum."""
        model_size = full_size = None
        device_halvings = 0
        # per-phase wall accounting for the last stream (observability:
        # where stage-01 time goes — host decode/batch, upload+dispatch,
        # result copy wait+unpack), the seconds of the stage01.* spans.
        # Read via self.stream_stats after a run.
        stats = self.stream_stats = {"source_s": 0.0, "dispatch_s": 0.0,
                                     "drain_s": 0.0, "downscale_s": 0.0}
        # every batch in flight, plus the one being started, holds a buffer
        copies = _HostCopies(self.device, PIPELINE_DEPTH + 2)

        def drain(entry):
            handle, batch, number = entry
            with span("stage01.drain", stats, "drain_s", number):
                host = copies.wait(handle)
                # unpacking leaves the pinned buffer free
                host = unpack_bits_host(host, model_size[0])
                copies.release(handle)
                frames = []
                for offset in range(batch.valid):
                    img = host[offset]
                    if model_size != full_size:
                        img = resize_nearest(img, full_size)
                    if invert:
                        img = 255 - img
                    frames.append(img)
            return batch.times, batch.indices, frames

        # the drain thread only in a world of one process: the gather of
        # every process's rows is a collective and must keep the
        # processes' program order
        drainer = _Drainer(drain, PIPELINE_DEPTH, process_count() == 1)
        try:
            batches = self._batches(source, frames_limit)
            for number in itertools.count():
                with span("stage01.source", stats, "source_s", number):
                    batch = next(batches, None)
                if batch is None:
                    break
                if model_size is None:
                    h, w = batch.frames.shape[1:3]
                    full_size = (w, h)
                    model_size = resolve_model_size(w, h, self.max_model_pixels)
                    if self.downscale == "device" and model_size != full_size:
                        dw, dh = full_size
                        while dw * dh > self.max_model_pixels:
                            dw, dh = int(dw / 2), int(dh / 2)
                            device_halvings += 1
                    self.fit_upload(full_size if device_halvings
                                    else model_size, device_halvings)

                frames = batch.frames
                if model_size != full_size and not device_halvings:
                    with span("stage01.downscale", stats, "downscale_s",
                              number):
                        frames = _downscale_batch(frames, model_size,
                                                  self.downscale_filter)

                with span("stage01.dispatch", stats, "dispatch_s", number):
                    handle = copies.start(self.dispatch(frames))
                yield from drainer.push((handle, batch, number))
            yield from drainer.finish()
        finally:
            drainer.close()

    def process_source(self, source: VideoFrameSource, frames_limit: int = 0,
                       invert: bool = True):
        """Run the full stage over a frame source.

        Returns (frame_times, frame_indices, binary_frames) where
        binary_frames is a list of uint8 [H, W] arrays; with ``invert`` the
        frames match the reference stage-01 artifact polarity (ink=255,
        ready for CC labeling).
        """
        frame_times: List[float] = []
        frame_indices: List[int] = []
        binaries: List[np.ndarray] = []
        for times, indices, frames in self.stream_source(source, frames_limit,
                                                         invert):
            frame_times.extend(times)
            frame_indices.extend(indices)
            binaries.extend(frames)
        return frame_times, frame_indices, binaries

    def _batches(self, source: VideoFrameSource, frames_limit: int):
        """The source's frames in padded batches of ``batch_size``; without
        one, the first frame sizes them by device memory."""
        frames = source.frames(frames_limit)
        if self.batch_size is None:
            first = next(frames, None)
            if first is None:
                return
            h, w = first[2].shape[:2]
            mw, mh = resolve_model_size(w, h, self.max_model_pixels)
            # each device of the data axis takes a batch its memory holds
            data = 1 if self.mesh is None else self.mesh.shape["data"]
            self.batch_size = default_batch_size(mw, mh, self.device) * data
            print(f"Stage 01: batch size {self.batch_size} for {mw}x{mh} "
                  f"frames on {self.device}"
                  + ("" if self.mesh is None else
                     f", {data}-way data axis")
                  + ("" if self.mesh is None or self.mesh.shape["model"] == 1
                     else f", {self.mesh.shape['model']}-way model axis"))
            frames = itertools.chain([first], frames)
        yield from batched(frames, self.batch_size)


def _downscale_batch(frames: np.ndarray, model_size: Tuple[int, int],
                     filter: str = "lanczos") -> np.ndarray:
    """Iterative halving on host. ``filter='lanczos'`` matches the
    reference's PIL resize (FCN_lecturenet.py:436 uses PIL.Image.LANCZOS);
    'area' matches cv2 INTER_AREA (box mean) — pixel values differ slightly
    near edges. Both are numpy (``utils/image.py``), equal to those calls."""
    halve = (halve_lanczos if filter == "lanczos" else
             lambda img: resize_area(img, (img.shape[1] // 2,
                                           img.shape[0] // 2)))
    out = np.empty((frames.shape[0], model_size[1], model_size[0], 3), np.uint8)
    for k in range(frames.shape[0]):
        img = frames[k]
        # halve until the pixel count reaches the target's — model_size
        # (from resolve_model_size) is the single source of the halving
        # rule, so the two can't drift apart
        while img.shape[0] * img.shape[1] > model_size[0] * model_size[1]:
            img = halve(img)
        out[k] = img
    return out
