"""Recycling device-worker binarizer — stage 01 in a child process.

:class:`WorkerBinarizer` runs the device path of stage 01 (the model, K2 on
its heads, K1 on its tail) in a CHILD process that owns the card and is
recycled (cleanly exited and respawned) whenever its resident memory
crosses a budget. Whatever the device-owning process accumulates over a
long run (host memory of the CUDA context and its pinned buffers, the
allocator's caches, anything a driver or library retains per transfer)
leaves with the child, and the card memory it held is released with its
context. The parent keeps the frame source (decode, sampling accounting —
pipeline/video.py semantics are untouched) and all downstream stages, and
never touches the card itself: the child's CUDA context is created after
the spawn, in the child. The child is stateless between batches, so
recycling at any chunk boundary is bit-exact: per-frame outputs don't
depend on batch composition (BN folded, inference mode — the same
invariance the staged/express equality tests rely on).

Two levers keep a recycle from stalling the stream:

* **The kernels are built once.** A child loads the CUDA kernels that
  ``ops/cuda_build.py`` compiled into ``csrc/build`` (nvcc runs only when
  a source is newer than its library), so a respawn costs the process
  start, the CUDA context, the checkpoint load and the first batch's
  cuDNN choice, not a compile. ``DEVICE_WORKER_COMPILE_CACHE`` (default
  :func:`default_compile_cache`; ``none`` disables) names the directory
  each child gives the CUDA driver as its JIT cache (``CUDA_CACHE_PATH``),
  for any PTX the child's kernels JIT-compile; the port's own kernels are
  SASS for sm_90a and need none. The child refuses a directory it does not
  own or that others can write, since the driver runs what it finds there.
* **Hot-spare prespawn** (``DEVICE_WORKER_PRESPAWN``, default on): the
  NEXT child is spawned and warmed in the background — CUDA init,
  checkpoint load, and a one-frame throwaway stream that runs the
  steady-state batch shape (partial batches are padded to the full batch
  size, video.py ``_pack``, so one frame exercises the exact kernels) —
  while the active child keeps streaming. At the recycle boundary the
  stream switches to the warm spare and the stall collapses to a queue
  handoff. Warm outputs are discarded; per-frame results are
  batch-composition-invariant, so the switch stays bit-exact.

  By default the spare is STANDING (``DEVICE_WORKER_PRESPAWN_EAGER``,
  default on): it spawns at stream start and again right after every
  promotion, so it has the whole budget period to come up. With
  ``eager=false`` it spawns when the active child's RSS crosses 3/4 of the
  budget. A standing spare costs one idle child (its CUDA context and the
  model's weights on the card).

Enable on the express pipeline with ``DEVICE_WORKER_RECYCLE_MB > 0``
(single-process, meshless runs only — a mesh keeps its replicas
in-process). The child builds ``Binarizer.from_config`` on the device the
parent names (the card by default; ``device="cpu"`` for the CPU), with the
same seeded random init under ``allow_random``, so its output equals the
in-process Binarizer's. The kernel launches happen in the child: each
stream's ``done`` message carries the child's K1 / K2 launch counts, which
the parent sums in ``launches``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.config import Config
from .video import VideoFrameSource

_CHUNK_FRAMES = 16      # frames per parent->child message
_FEED_DEPTH = 4         # chunks in flight toward the child
_RESULT_DEPTH = 32      # drained batches buffered toward the parent
_PRESPAWN_FRAC = 0.75   # spawn the spare at this fraction of the budget
_MAX_SPARE_FAILURES = 3  # per stream; then fall back to sync respawns


def default_compile_cache() -> str:
    """The CUDA driver's JIT-cache dir for worker children. Rooted in the
    user's home so another local user can't pre-create/poison it (the child
    additionally refuses any cache dir it doesn't own — see
    ``_child_main``); tempdir fallback is uid-keyed for homeless service
    accounts."""
    home = os.environ.get("HOME")
    if home and os.path.isdir(home):
        return os.path.join(home, ".cache", "lecturemath", "cuda_cache")
    return os.path.join(tempfile.gettempdir(),
                        f"lecturemath_cuda_cache_{os.getuid()}")


def _vmrss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


class _QueueSource(VideoFrameSource):
    """Frame source fed by the parent over a queue.

    Yields (time, index, frame) items from ``("chunk", times, indices,
    frames)`` messages until a ``None`` end-of-stream marker; the
    Binarizer batches them (including the auto-batch-size peek) exactly as
    a real video's."""

    def __init__(self, feed_q):
        self._feed_q = feed_q

    def frames(self, frames_limit: int = 0):
        while True:
            msg = self._feed_q.get()
            if msg is None:
                return
            _, times, indices, frames = msg
            for k in range(len(times)):
                yield times[k], indices[k], frames[k]


def _pack_result(frames: List[np.ndarray]):
    stack = np.stack(frames) > 0
    return np.packbits(stack.reshape(-1)), stack.shape


def _unpack_result(bits: np.ndarray, shape) -> List[np.ndarray]:
    n = int(np.prod(shape))
    flat = np.unpackbits(bits, count=n).reshape(shape)
    return list(flat * np.uint8(255))


def _child_main(cfg_values: dict, device: Optional[str],
                allow_random: bool, binarizer_kwargs: dict,
                compile_cache: Optional[str], feed_q, result_q) -> None:
    """Device-owning child: builds the Binarizer, then serves
    ``("stream", invert)`` requests until an ``"exit"`` message. Every
    drained batch ships back bit-packed (binary frames are 0/255, so
    packbits is lossless and 8x smaller over the pipe)."""
    import traceback

    try:
        if compile_cache:
            # the driver runs the programs it finds in its JIT cache —
            # refuse a dir another user could write (poisoned-cache
            # CWE-379): must be owned by us and not world-writable. Set
            # before the first CUDA call, which reads it.
            os.makedirs(compile_cache, mode=0o700, exist_ok=True)
            st = os.stat(compile_cache)
            if st.st_uid == os.getuid() and not (st.st_mode & 0o002):
                os.environ["CUDA_CACHE_PATH"] = compile_cache
        from .binarize import Binarizer
        from .server import _launch_counts

        binarizer = Binarizer.from_config(Config(dict(cfg_values)),
                                          allow_random=allow_random,
                                          device=device, **binarizer_kwargs)
        result_q.put(("ready", _vmrss_mb(), time.time()))
        while True:
            msg = feed_q.get()
            if msg == "exit" or msg is None:
                return
            _, invert = msg
            before = _launch_counts()
            source = _QueueSource(feed_q)
            for times, indices, frames in binarizer.stream_source(
                    source, 0, invert):
                bits, shape = _pack_result(frames)
                result_q.put(("batch", times, indices, bits, shape,
                              _vmrss_mb()))
            launches = {name: count - before[name]
                        for name, count in _launch_counts().items()}
            result_q.put(("done", dict(binarizer.stream_stats),
                          _vmrss_mb(), launches))
    except BaseException:
        try:
            result_q.put(("error", traceback.format_exc()))
        except Exception:
            pass


def _drain_results(mp_q, rx, stop: threading.Event) -> None:
    """Forward every child result into an in-process queue.

    This thread exists to absorb the ONE indefinite block a
    ``multiprocessing.Queue.get`` can hit: a child SIGKILLed mid-write
    (the OOM regime this worker contains) leaves a partial pickle in the
    pipe — ``poll()`` sees data, so even ``get(timeout)`` enters
    ``recv_bytes`` and never returns (the parent's own copy of the pipe's
    write end keeps EOF from arriving). Only this disposable daemon
    thread can get stuck there; the parent reads ``rx`` (a plain
    ``queue.Queue``) with real timeouts and liveness checks."""
    while not stop.is_set():
        try:
            msg = mp_q.get(timeout=0.2)
        except queue_mod.Empty:
            continue
        except (EOFError, OSError):
            return
        rx.put(msg)


class _Child:
    """One spawned device child: its process, queues, and result drainer.

    ``spawn()`` returns immediately — the child signals readiness with a
    ``("ready", rss, time)`` message; ``wait_ready()`` blocks for it,
    ``poll_ready()`` checks without blocking (the hot-spare path).
    ``stats`` records whether it started as a spare, its start to ready
    (s) and its RSS at ready and at its peak (MB)."""

    def __init__(self, ctx, cfg_values, device, allow_random,
                 binarizer_kwargs, compile_cache, spare):
        self.feed_q = ctx.Queue(maxsize=_FEED_DEPTH)
        self.result_q = ctx.Queue(maxsize=_RESULT_DEPTH)
        self.rx = queue_mod.Queue()
        self._drain_stop = threading.Event()
        threading.Thread(target=_drain_results,
                         args=(self.result_q, self.rx, self._drain_stop),
                         daemon=True).start()
        self.started_at = time.time()
        self.proc = ctx.Process(
            target=_child_main,
            args=(cfg_values, device, allow_random, binarizer_kwargs,
                  compile_cache, self.feed_q, self.result_q),
            daemon=True)
        self.proc.start()
        self.ready = False
        self.warm_sent = False
        self.stats = {"spare": spare, "start_to_ready_s": None,
                      "ready_rss_mb": None, "peak_rss_mb": None}

    # ------------------------------------------------------------- results

    def get(self, timeout: float = 3600.0):
        """Result get that notices a dead child instead of hanging. Reads
        the in-process mirror queue (see ``_drain_results``) — a plain
        ``queue.Queue`` whose timeouts are real even when the child was
        killed mid-write into the mp pipe."""
        deadline_step = 5.0
        waited = 0.0
        while True:
            try:
                msg = self.rx.get(timeout=deadline_step)
            except queue_mod.Empty:
                waited += deadline_step
                if not self.proc.is_alive():
                    # the child's final message can still be mid-flush in
                    # its queue feeder thread when is_alive() flips — one
                    # bounded drain before declaring the result lost
                    try:
                        msg = self.rx.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            "device worker died without reporting an error "
                            f"(exitcode {self.proc.exitcode})")
                elif waited >= timeout:
                    raise RuntimeError(
                        f"device worker produced no result for {waited:.0f}s")
                else:
                    continue
            if msg[0] == "error":
                self.close()
                raise RuntimeError(f"device worker failed:\n{msg[1]}")
            return msg

    def _on_ready(self, msg) -> None:
        if msg[0] != "ready":
            raise RuntimeError(f"device worker failed to start: {msg!r}")
        _, rss, ready_at = msg
        self.ready = True
        self.stats.update(start_to_ready_s=ready_at - self.started_at,
                          ready_rss_mb=rss, peak_rss_mb=rss)

    def wait_ready(self) -> None:
        if self.ready:
            return
        self._on_ready(self.get())

    def poll_ready(self) -> bool:
        """Non-blocking readiness check. Raises if the child reported an
        error or died before signalling ready."""
        if self.ready:
            return True
        try:
            msg = self.rx.get_nowait()
        except queue_mod.Empty:
            if not self.proc.is_alive():
                raise RuntimeError(
                    "device worker died during startup "
                    f"(exitcode {self.proc.exitcode})")
            return False
        if msg[0] == "error":
            self.close()
            raise RuntimeError(f"device worker failed:\n{msg[1]}")
        self._on_ready(msg)
        return True

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Exit the child cleanly (idempotent), without ever blocking
        unboundedly: on an abort mid-stream the feed queue can be FULL and
        the child can be blocked on a full RESULT queue — a blind blocking
        put here would deadlock against it. ``None`` is the close message
        for both child states (mid-stream it ends the in-flight stream,
        at the command loop it exits); results are drained so a blocked
        child can make progress toward it. A child not yet seen ready has
        no stream to end and is terminated without waiting out its
        start-up."""
        if self.proc is not None and self.proc.is_alive():
            try:
                deadline = time.monotonic() + (30.0 if self.ready else 0.0)
                while self.proc.is_alive() and time.monotonic() < deadline:
                    try:
                        self.feed_q.put_nowait(None)
                    except queue_mod.Full:
                        pass
                    try:
                        # keep the in-process mirror drained (the drainer
                        # thread keeps the mp result queue itself flowing,
                        # so a child blocked on a full result queue can
                        # make progress toward the exit message)
                        self.rx.get_nowait()
                    except queue_mod.Empty:
                        pass
                    self.proc.join(timeout=0.25)
            finally:
                if self.proc.is_alive():
                    self.proc.terminate()
                    self.proc.join(timeout=10)
                    if self.proc.is_alive():
                        self.proc.kill()
                        self.proc.join(timeout=10)
        self.proc = None
        self._drain_stop.set()
        for q in (self.feed_q, self.result_q):
            # cancel_join_thread: a child that died with the feed pipe
            # mid-write leaves the parent's feeder thread blocked forever;
            # without this, the queue finalizer would JOIN that thread at
            # interpreter exit and hang the process
            if q is not None:
                q.cancel_join_thread()
                q.close()
        self.feed_q = self.result_q = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()


class WorkerBinarizer:
    """Drop-in for :class:`Binarizer`'s streaming surface
    (``stream_source`` / ``process_source``) that runs the device path in
    a recycled child process. See the module docstring for why.

    ``recycle_mb``: child-RSS budget; when a drained batch reports more,
    the current stream is cleanly split — the child drains its in-flight
    device batches, exits, and a fresh child resumes with the next frames.
    ``0`` disables recycling (one child for the whole run, still keeping
    the device-owning process apart from the parent). The results are
    bit-identical to the in-process Binarizer at ANY recycle granularity
    (tested).

    ``device``: where the child runs the model (None: the card; ``"cpu"``
    for the CPU). The parent only relays and never touches the card.

    ``prespawn``: overlap each respawn with the running stream (module
    docstring). ``compile_cache``: the children's CUDA JIT-cache dir;
    ``None`` picks :func:`default_compile_cache`, ``""`` or ``"none"``
    disables.

    What the children did is kept for inspection: ``launches`` (K1 and K2
    launches of the streams, warm-ups excluded), ``children`` (each child's
    ``stats``, in the order they were spawned) and ``recycle_stalls_s``
    (the stream's wait at each recycle).
    """

    def __init__(self, config: Config, recycle_mb: float = 0.0,
                 chunk_frames: int = _CHUNK_FRAMES,
                 allow_random: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 binarizer_kwargs: Optional[dict] = None,
                 prespawn: bool = True,
                 prespawn_eager: bool = True,
                 compile_cache: Optional[str] = None):
        self._cfg_values = dict(config._values)
        self.recycle_mb = float(recycle_mb)
        self.chunk_frames = max(1, int(chunk_frames))
        self.allow_random = allow_random
        self.binarizer_kwargs = dict(binarizer_kwargs or {})
        self.prespawn = bool(prespawn)
        self.prespawn_eager = bool(prespawn_eager)
        if compile_cache is None:
            compile_cache = default_compile_cache()
        self.compile_cache = (None if str(compile_cache).lower()
                              in ("", "none") else str(compile_cache))
        if device is not None:
            # parsed here, resolved in the child: the parent creates no
            # CUDA context
            if torch.device(device).type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {device}: use 'cuda' "
                                 f"or 'cpu'")
            device = str(device)
        self.device = device
        self.recycles = 0
        self.stream_stats = {}
        self.launches: Dict[str, int] = {}
        self.children: List[dict] = []
        self.recycle_stalls_s: List[float] = []
        self._ctx = mp.get_context("spawn")
        self._active: Optional[_Child] = None
        self._spare: Optional[_Child] = None
        self._warm_frame: Optional[np.ndarray] = None
        self._spare_failures = 0

    @classmethod
    def from_config(cls, config: Config, allow_random: bool = False,
                    **kwargs) -> "WorkerBinarizer":
        kwargs.setdefault("recycle_mb",
                          config.get_float("DEVICE_WORKER_RECYCLE_MB", 0.0))
        kwargs.setdefault("chunk_frames",
                          config.get_int("DEVICE_WORKER_CHUNK_FRAMES",
                                         _CHUNK_FRAMES))
        kwargs.setdefault("prespawn",
                          config.get_bool("DEVICE_WORKER_PRESPAWN", True))
        kwargs.setdefault("prespawn_eager",
                          config.get_bool("DEVICE_WORKER_PRESPAWN_EAGER",
                                          True))
        cache = config.get_str("DEVICE_WORKER_COMPILE_CACHE", "auto")
        if cache != "auto":
            kwargs.setdefault("compile_cache", cache)
        return cls(config, allow_random=allow_random, **kwargs)

    # ------------------------------------------------------------ lifecycle

    @property
    def _child(self):
        """The active child's process — test/introspection surface."""
        return self._active.proc if self._active is not None else None

    def _new_child(self, spare: bool = True) -> _Child:
        child = _Child(self._ctx, self._cfg_values, self.device,
                       self.allow_random, self.binarizer_kwargs,
                       self.compile_cache, spare)
        self.children.append(child.stats)
        return child

    def _spawn(self) -> None:
        self._active = self._new_child(spare=False)
        self._active.wait_ready()

    def close(self) -> None:
        """Exit the children cleanly (idempotent, bounded)."""
        for attr in ("_spare", "_active"):
            child = getattr(self, attr)
            if child is not None:
                child.close()
                setattr(self, attr, None)

    def __del__(self):  # best effort — tests use close() explicitly
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------ hot spare

    def _maybe_start_spare(self, rss: float) -> None:
        """Start/advance the spare's background warmup. Called at chunk
        boundaries with the active child's latest RSS report. Never raises
        past itself: a failed spare falls back to the synchronous respawn
        the recycle path always supports — but after
        ``_MAX_SPARE_FAILURES`` startup deaths in one stream it stops
        retrying (a card that cannot start a child would otherwise fork a
        fresh one every other batch for the rest of the stream); failures
        are visible as ``stream_stats["spare_failures"]``."""
        if not (self.prespawn and self.recycle_mb > 0):
            return
        if self._spare_failures >= _MAX_SPARE_FAILURES:
            return
        try:
            if self._spare is None:
                if (self.prespawn_eager
                        or rss > _PRESPAWN_FRAC * self.recycle_mb):
                    self._spare = self._new_child()
                return
            if self._spare.warm_sent or self._warm_frame is None:
                return
            if self._spare.poll_ready():
                # a one-frame throwaway stream: padded to the full batch
                # (video.py _pack), it runs the steady-state shape (cuDNN's
                # choice, the allocator) while the active child streams
                self._spare.feed_q.put(("stream", True), timeout=5)
                self._spare.feed_q.put(
                    ("chunk", [0.0], [0], self._warm_frame), timeout=5)
                self._spare.feed_q.put(None, timeout=5)
                self._spare.warm_sent = True
        except Exception:
            self._spare_failures += 1
            self.stream_stats["spare_failures"] = self._spare_failures
            if self._spare is not None:
                self._spare.close()
                self._spare = None

    def _take_spare(self) -> bool:
        """Promote the (ideally warm) spare to active. False if there is
        none or it failed — the caller decides whether to spawn now."""
        spare, self._spare = self._spare, None
        if spare is None:
            return False
        try:
            spare.wait_ready()
            if spare.warm_sent:
                # discard the warmup stream's outputs
                while spare.get()[0] != "done":
                    pass
            self._active = spare
            return True
        except Exception:
            spare.close()
            return False

    def _promote_or_respawn(self) -> None:
        """Replace the closed active child: take the spare, else spawn
        synchronously."""
        if not self._take_spare():
            self._spawn()

    # ------------------------------------------------------------ streaming

    def stream_source(self, source: VideoFrameSource, frames_limit: int = 0,
                      invert: bool = True):
        """Same contract as Binarizer.stream_source: yields
        (times, indices, frames) per drained device batch, in order."""
        stats = self.stream_stats = {"source_s": 0.0, "dispatch_s": 0.0,
                                     "drain_s": 0.0, "downscale_s": 0.0,
                                     "recycles": 0, "respawn_stall_s": 0.0}
        self._spare_failures = 0
        if self._spare is not None:
            # a never-promoted spare from a previous stream carries that
            # stream's warmup state (shapes, batch size) — retire it; this
            # stream re-warms its own
            self._spare.close()
            self._spare = None
        if self._active is None or not self._active.alive:
            if self._active is not None:
                self._active.close()
            self._spawn()
        self._active.feed_q.put(("stream", invert))
        self._maybe_start_spare(0.0)  # eager mode: standing spare from t=0

        pc = time.perf_counter
        need_recycle = False
        self._warm_frame = None
        frame_iter = source.frames(frames_limit)
        chunk_t: list = []
        chunk_i: list = []
        chunk_f: list = []

        def decode_next():
            t0 = pc()
            item = next(frame_iter, None)
            stats["source_s"] += pc() - t0
            return item

        def drain_one(block: bool):
            nonlocal need_recycle
            if block:
                msg = self._active.get()
            else:
                try:
                    msg = self._active.rx.get_nowait()
                except queue_mod.Empty:
                    return None
                if msg[0] == "error":
                    self.close()
                    raise RuntimeError(f"device worker failed:\n{msg[1]}")
            if msg[0] == "done":
                _, child_stats, rss, launches = msg
                for key, val in child_stats.items():
                    if key != "source_s":  # child's source_s is queue wait
                        stats[key] = stats.get(key, 0.0) + val
                for name, count in launches.items():
                    self.launches[name] = self.launches.get(name, 0) + count
                self._note_rss(rss)
                return "done"
            _, times, indices, bits, shape, rss = msg
            self._note_rss(rss)
            if self.recycle_mb and rss > self.recycle_mb:
                need_recycle = True
            self._maybe_start_spare(rss)
            return times, indices, _unpack_result(bits, shape)

        def feed(msg):
            """Queue put that keeps draining results — the child blocks on
            a full result queue, so a blind blocking put could deadlock.
            A child killed without an error message (e.g. OOM SIGKILL —
            exactly the regime this worker contains) leaves the feed queue
            full forever, so the Full path also checks liveness."""
            while True:
                try:
                    self._active.feed_q.put(msg, timeout=0.5)
                    return []
                except queue_mod.Full:
                    out = drain_one(block=False)
                    if out is not None and out != "done":
                        yield out
                    elif out is None and not self._active.alive:
                        time.sleep(0.2)  # let a mid-flush message land
                        out = drain_one(block=False)
                        if out is None:
                            raise RuntimeError(
                                "device worker died mid-stream (exitcode "
                                f"{self._active.proc.exitcode})")
                        if out != "done":
                            yield out

        def end_stream():
            """EOS -> drain everything the child still owes this stream."""
            yield from feed(None)
            while True:
                out = drain_one(block=True)
                if out == "done":
                    break
                yield out

        def recycle(final: bool = False):
            nonlocal need_recycle
            t0 = pc()
            self._active.close()
            if final:
                # end of stream: hand off to the spare if one is up, but
                # never block on a fresh spawn nobody may consume — the
                # next stream spawns lazily
                if not self._take_spare():
                    self._active = None
            else:
                self._promote_or_respawn()
                # eager mode: the next spare starts warming now, not at
                # 3/4 budget — it gets the whole budget period to init
                self._maybe_start_spare(0.0)
            stall = pc() - t0
            stats["respawn_stall_s"] += stall
            self.recycle_stalls_s.append(stall)
            self.recycles += 1
            stats["recycles"] += 1
            need_recycle = False

        item = decode_next()
        while item is not None:
            chunk_t.append(item[0])
            chunk_i.append(item[1])
            chunk_f.append(item[2])
            if len(chunk_t) == self.chunk_frames:
                frames = np.stack(chunk_f)
                yield from feed(("chunk", chunk_t, chunk_i, frames))
                if self.prespawn and self.recycle_mb > 0:
                    # copy: a view would pin the whole chunk array
                    # (~100 MB at 1080p) in the parent until the next chunk
                    self._warm_frame = frames[-1:].copy()
                chunk_t, chunk_i, chunk_f = [], [], []
                out = drain_one(block=False)
                if out is not None and out != "done":
                    yield out
                if need_recycle:
                    yield from end_stream()
                    recycle()
                    self._active.feed_q.put(("stream", invert))
            item = decode_next()

        if chunk_t:
            yield from feed(("chunk", chunk_t, chunk_i, np.stack(chunk_f)))
        yield from end_stream()
        if need_recycle:
            # budget crossed in the final drain: retire the child now so
            # the next stream (e.g. the next lecture) starts fresh — with
            # a warm spare available this is a handoff, not a respawn
            recycle(final=True)
        self._warm_frame = None

    def _note_rss(self, rss: float) -> None:
        """Raise the active child's peak RSS."""
        stats = self._active.stats
        stats["peak_rss_mb"] = max(stats["peak_rss_mb"] or 0.0, rss)

    def process_source(self, source: VideoFrameSource, frames_limit: int = 0,
                       invert: bool = True):
        frame_times: list = []
        frame_indices: list = []
        binaries: list = []
        for times, indices, frames in self.stream_source(source, frames_limit,
                                                         invert):
            frame_times.extend(times)
            frame_indices.extend(indices)
            binaries.extend(frames)
        return frame_times, frame_indices, binaries
