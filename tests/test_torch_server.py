"""The port's serving surface (lecturemath_tpu_torch.pipeline.server and
cli.serve / cli.binarize_image) on the CPU: the scenarios of
tests/test_binarize_server.py against the port, HTTP bodies through the
port's PNG codec, and parity with the JAX package's BinarizeService and
binarize_image CLI on the same seeded frames and weights (fp32, TINY
widths)."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.server import BinarizeService as JaxService
from lecturemath_tpu.utils.synthetic import \
    threshold_binarizer_variables as jax_threshold_variables
from lecturemath_tpu_torch.core.backend_probe import BackendUnavailable
from lecturemath_tpu_torch.models.convert import (load_checkpoint,
                                                  save_checkpoint,
                                                  state_dict_from_flax)
from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                         FCNLectureNet)
from lecturemath_tpu_torch.pipeline import server as server_module
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.server import (BinarizeService,
                                                   _WorkItem, decode_image,
                                                   serve)
from lecturemath_tpu_torch.utils.png import decode_png_gray, encode_png
from lecturemath_tpu_torch.utils.synthetic import \
    threshold_binarizer_variables

torch.set_num_threads(1)

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(3, 2), kernel_size=3, pixel_kernel_size=3)
NET_CONFIG = FCNConfig(**TINY)


def _frame(width=64, height=48, glyph=True):
    rgb = np.full((height, width, 3), 220, np.uint8)
    if glyph:
        rgb[10:20, 12:30] = 20   # dark -> ink under the threshold head
    return rgb


def _model(state_dict):
    model = FCNLectureNet(NET_CONFIG)
    model.load_state_dict(state_dict, strict=True)
    return model


def _binarizer(state_dict=None):
    if state_dict is None:
        state_dict = threshold_binarizer_variables(NET_CONFIG)
    return Binarizer(_model(state_dict), device="cpu", upload_format="rgb")


@pytest.fixture(scope="module")
def service():
    service = BinarizeService(_binarizer(), model_size=(64, 48),
                              max_batch=4, batch_window_ms=50.0)
    yield service
    service.close()


@pytest.fixture
def http(service):
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    request = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(request, timeout=120) as r:
        return r.read()


def test_single_request_round_trip(service):
    binary = service.binarize_rgb(_frame())
    assert binary.shape == (48, 64)
    assert (binary[12:18, 14:28] == 0).all()      # glyph is ink
    assert (binary[0:8, 0:8] == 255).all()        # background stays


def test_resolution_adaptation(service):
    """Inputs at other resolutions resize through the fixed bucket (area)
    and come back at their own size (nearest)."""
    big = service.binarize_rgb(_frame(width=128, height=96))
    assert big.shape == (96, 128)
    assert (big[12:18, 14:28] == 0).mean() > 0.8   # glyph survives resize
    assert (big[40:96, 60:128] == 255).all()       # background stays


def test_concurrent_requests_micro_batch(service):
    """Six concurrent callers land in fewer dispatches than requests, and
    every caller gets its own frame back."""
    before = service.stats()
    results = [None] * 6

    def call(k):
        results[k] = (k, service.binarize_rgb(_frame(glyph=(k % 2 == 0))))

    threads = [threading.Thread(target=call, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for k, binary in results:
        assert (binary[12:18, 14:28] == 0).any() == (k % 2 == 0)
    after = service.stats()
    assert after["requests"] - before["requests"] == 6
    assert after["batches"] - before["batches"] < 6   # batching happened
    assert after["mean_batch"] >= 1.0
    # the CPU runs eagerly: no graph replays
    assert after["graph_replays"] == 0


def test_http_contract(service, http):
    with urllib.request.urlopen(f"{http}/healthz", timeout=10) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["model_size"] == [64, 48]
    assert health["device"] == "cpu" and health["graphs"] is False

    payload = encode_png(_frame()[:, :, ::-1])   # encode_png takes BGR
    binary = decode_png_gray(_post(f"{http}/binarize", payload))
    assert (binary[12:18, 14:28] == 0).all()
    inverted = decode_png_gray(_post(f"{http}/binarize?invert=1", payload))
    assert (inverted[12:18, 14:28] == 255).all()
    np.testing.assert_array_equal(inverted, 255 - binary)

    with pytest.raises(urllib.error.HTTPError) as excinfo:
        _post(f"{http}/binarize", b"not an image")
    assert excinfo.value.code == 400

    with urllib.request.urlopen(f"{http}/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["uptime_s"] >= 0


def test_http_answer_bytes_equal_cv2(service, http):
    """The answer PNG is what cv2.imencode writes for the same binary."""
    frame = _frame(width=80, height=60)
    body = _post(f"{http}/binarize", encode_png(frame[:, :, ::-1]))
    binary = service.binarize_rgb(frame)
    ok, expected = cv2.imencode(".png", binary)
    assert ok and body == expected.tobytes()


def test_http_bodies_other_than_png(service, http, monkeypatch):
    """A JPEG body decodes through OpenCV where it is installed; without
    OpenCV the answer is 400 naming the format. Gray and RGBA PNGs decode
    without it."""
    ok, jpeg = cv2.imencode(".jpg", _frame()[:, :, ::-1])
    assert ok
    binary = decode_png_gray(_post(f"{http}/binarize", jpeg.tobytes()))
    assert (binary[12:18, 14:28] == 0).all()

    monkeypatch.setattr(server_module, "_opencv", lambda: None)
    with pytest.raises(urllib.error.HTTPError) as excinfo:
        _post(f"{http}/binarize", jpeg.tobytes())
    assert excinfo.value.code == 400
    assert "JPEG" in json.loads(excinfo.value.read())["error"]

    gray = encode_png(_frame()[:, :, 0])
    binary = decode_png_gray(_post(f"{http}/binarize", gray))
    assert (binary[12:18, 14:28] == 0).all()
    ok, rgba = cv2.imencode(".png", cv2.cvtColor(_frame()[:, :, ::-1],
                                                 cv2.COLOR_BGR2BGRA))
    assert ok
    np.testing.assert_array_equal(decode_image(rgba.tobytes()), _frame())


def test_decode_image_equals_cv2_imdecode():
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    for params in ([], [cv2.IMWRITE_PNG_COMPRESSION, 9]):
        ok, buf = cv2.imencode(".png", bgr, params)
        assert ok
        np.testing.assert_array_equal(
            decode_image(buf.tobytes()),
            cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1])
    ok, buf = cv2.imencode(".png", bgr[:, :, 0])
    np.testing.assert_array_equal(
        decode_image(buf.tobytes()),
        cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1])


def test_hot_reload_swaps_weights_without_restart(tmp_path):
    """A factory-built service swaps to a .dat checkpoint with a different
    threshold; reload without a factory is a clear error."""
    blind_path = str(tmp_path / "blind.dat")
    save_checkpoint(threshold_binarizer_variables(NET_CONFIG,
                                                  threshold_gray=5.0),
                    blind_path)

    def factory(checkpoint=None):
        return _binarizer(None if checkpoint is None
                          else load_checkpoint(checkpoint))

    service = BinarizeService(factory(), model_size=(64, 48), max_batch=2,
                              batch_window_ms=5.0,
                              binarizer_factory=factory)
    try:
        before = service.binarize_rgb(_frame())
        assert (before[12:18, 14:28] == 0).all()       # glyph is ink

        out = service.reload_checkpoint(blind_path)
        assert out["ok"] and service.stats()["reloads"] == 1
        after = service.binarize_rgb(_frame())
        assert (after == 255).all()                    # nothing under 5.0

        service.reload_checkpoint(None)                # back to factory
        np.testing.assert_array_equal(service.binarize_rgb(_frame()), before)
    finally:
        service.close()

    no_factory = BinarizeService(factory(), model_size=(64, 48),
                                 max_batch=1, batch_window_ms=1.0,
                                 warmup=False)
    try:
        with pytest.raises(RuntimeError, match="binarizer_factory"):
            no_factory.reload_checkpoint(None)
    finally:
        no_factory.close()


def test_hot_reload_under_concurrent_traffic(tmp_path):
    """Requests keep succeeding WHILE a reload swaps the weights: every
    response is the old model's or the new one's, never an error or a
    mix."""
    blind_path = str(tmp_path / "blind.dat")
    save_checkpoint(threshold_binarizer_variables(NET_CONFIG,
                                                  threshold_gray=5.0),
                    blind_path)

    def factory(checkpoint=None):
        return _binarizer(None if checkpoint is None
                          else load_checkpoint(checkpoint))

    service = BinarizeService(factory(), model_size=(64, 48), max_batch=4,
                              batch_window_ms=2.0,
                              binarizer_factory=factory)
    try:
        frame = _frame()
        old = service.binarize_rgb(frame)
        results, errors = [], []

        def caller():
            for _ in range(12):
                try:
                    results.append(service.binarize_rgb(frame))
                except Exception as err:  # noqa: BLE001
                    errors.append(err)

        threads = [threading.Thread(target=caller) for _ in range(4)]
        for t in threads:
            t.start()
        service.reload_checkpoint(blind_path)   # swap mid-traffic
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors
        assert len(results) == 48
        new = service.binarize_rgb(frame)
        assert (new == 255).all()               # new weights in effect
        for out in results:                     # old XOR new, never a mix
            assert (out == old).all() or (out == new).all()
    finally:
        service.close()


def test_stuck_dispatch_fails_fast_and_flags_health():
    """A device dying mid-serving leaves the worker hung inside a dispatch;
    later callers fail at once and /healthz answers 503."""
    service = BinarizeService(_binarizer(), model_size=(64, 48), max_batch=2,
                              batch_window_ms=1.0, warmup=False,
                              request_timeout_s=0.5)
    release = threading.Event()

    def hung_dispatch(frames, active=None):
        release.wait(30)
        raise RuntimeError("backend died")

    service._dispatch = hung_dispatch
    try:
        assert service.health()["ok"]
        with pytest.raises(RuntimeError, match="timed out"):
            service.binarize_rgb(_frame())      # first caller hits backstop

        deadline = time.monotonic() + 10
        while service.health()["ok"] and time.monotonic() < deadline:
            time.sleep(0.05)
        health = service.health()
        assert not health["ok"]
        assert health["dispatch_stuck_s"] >= 0.5

        start = time.monotonic()
        with pytest.raises(RuntimeError, match="stuck"):
            service.binarize_rgb(_frame())
        assert time.monotonic() - start < 0.3

        server = serve(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address
        try:
            with pytest.raises(urllib.error.HTTPError) as excinfo:
                urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                       timeout=10)
            assert excinfo.value.code == 503
            assert json.loads(excinfo.value.read())["ok"] is False
        finally:
            server.shutdown()
            server.server_close()
    finally:
        release.set()                           # unwedge the worker
        service.close()


def test_backend_death_latches_unhealthy_until_recovery():
    """A dispatch dying of backend death (the bounded fetch) latches the
    service unhealthy until a later dispatch succeeds."""
    service = BinarizeService(_binarizer(), model_size=(64, 48), max_batch=2,
                              batch_window_ms=1.0, warmup=False,
                              request_timeout_s=30)
    real_dispatch = service._dispatch
    dead = {"on": True}

    def dispatch(frames, active=None):
        if dead["on"]:
            raise BackendUnavailable("device fetch hung for 1 s")
        return real_dispatch(frames, active)

    service._dispatch = dispatch
    try:
        with pytest.raises(BackendUnavailable):
            service.binarize_rgb(_frame())
        health = service.health()
        assert not health["ok"] and "fetch hung" in health["backend_dead"]
        with pytest.raises(RuntimeError, match="unhealthy"):
            service.binarize_rgb(_frame())

        dead["on"] = False          # the card recovers
        work = _WorkItem(np.asarray(_frame()))
        service._queue.put(work)
        assert work.event.wait(60) and work.error is None
        assert service.health()["ok"]
        assert service.binarize_rgb(_frame()).shape == (48, 64)
    finally:
        service.close()


def test_backend_death_from_the_bounded_fetch(monkeypatch):
    """The latch's real trigger: Binarizer.fetch's deadline."""
    from lecturemath_tpu_torch.pipeline import binarize as port_binarize

    service = BinarizeService(_binarizer(), model_size=(64, 48), max_batch=1,
                              batch_window_ms=1.0, warmup=False)
    monkeypatch.setenv("LM_FETCH_TIMEOUT_S", "0.2")
    monkeypatch.setattr(port_binarize, "_wait_host_copy",
                        lambda host, done: time.sleep(30))
    try:
        with pytest.raises(BackendUnavailable, match="fetch hung"):
            service.binarize_rgb(_frame())
        assert "fetch hung" in service.health()["backend_dead"]
    finally:
        service.close()


# ------------------------------------------------------ parity with JAX


def _lecture_frames(width, height, n, seed):
    """Board-like RGB frames: a noisy light board with dark strokes."""
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(200, 12, (n, height, width, 3)), 0,
                     255).astype(np.uint8)
    for k in range(n):
        for _ in range(6):
            y, x = rng.integers(0, height - 6), rng.integers(0, width - 12)
            frames[k, y:y + rng.integers(2, 6), x:x + rng.integers(4, 12)] = \
                rng.integers(10, 90)
    return frames


@pytest.fixture(scope="module")
def twin_services():
    cfg = jfcn.FCNConfig(**TINY)
    variables = jax_threshold_variables(cfg)
    jax_service = JaxService(
        JaxBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32), variables,
                     upload_format="rgb"),
        model_size=(64, 48), max_batch=4, batch_window_ms=1.0)
    port_service = BinarizeService(
        _binarizer(state_dict_from_flax(variables)), model_size=(64, 48),
        max_batch=4, batch_window_ms=1.0)
    yield jax_service, port_service
    jax_service.close()
    port_service.close()


@pytest.mark.parametrize("width,height", [(64, 48), (128, 96), (192, 144),
                                          (80, 60), (100, 70), (40, 30)],
                         ids=["1x", "2x", "3x", "fractional-1.25x",
                              "fractional-mixed", "upscale"])
def test_binaries_equal_jax_service(twin_services, width, height):
    """The same frames through both services: identical binaries. OpenCV's
    area arithmetic (box sums, f32 area weights in its order, 11-bit
    linear weights for upscales) is reproduced exactly by
    utils/image.py, so the fractional and upscale sizes are held to
    exact equality too (bound: 0 differing pixels)."""
    jax_service, port_service = twin_services
    frames = _lecture_frames(width, height, 3, seed=width + height)
    for frame in frames:
        ours = port_service.binarize_rgb(frame)
        theirs = jax_service.binarize_rgb(frame)
        assert ours.shape == theirs.shape == (height, width)
        np.testing.assert_array_equal(ours, theirs)
    assert (ours == 0).any() and (ours == 255).any()


# ------------------------------------------------------------ the CLIs


def _workspace(tmp_path):
    conf = tmp_path / "serve.conf"
    lines = [f"OUTPUT_PATH = {tmp_path}/output"]
    names = {"down_filters": "DOWN_CONV_FILTERS", "upsample_filters":
             "UPSAMPLE_FILTERS", "up_filters": "UP_CONV_FILTERS"}
    for key, name in names.items():
        lines += [f"FCN_BINARIZER_NET_{name}_{i} = {v}"
                  for i, v in enumerate(TINY[key], start=1)]
    lines += [f"FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE = "
              f"{TINY['mid_filters']}",
              f"FCN_BINARIZER_NET_PIXEL_FEATURES_1 = "
              f"{TINY['pixel_features'][0]}",
              f"FCN_BINARIZER_NET_PIXEL_FEATURES_2 = "
              f"{TINY['pixel_features'][1]}",
              f"FCN_BINARIZER_NET_KERNEL_SIZE = {TINY['kernel_size']}",
              f"FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = "
              f"{TINY['pixel_kernel_size']}",
              f"BINARIZATION_FCN_LECTURENET_DIR = {tmp_path}/models",
              "BINARIZATION_FCN_LECTURENET_FILENAME = tiny.dat"]
    conf.write_text("\n".join(lines) + "\n")
    (tmp_path / "models").mkdir()
    cfg = jfcn.FCNConfig(**TINY)
    save_checkpoint(state_dict_from_flax(jax_threshold_variables(cfg)),
                    str(tmp_path / "models" / "tiny.dat"))
    return str(conf)


def test_binarize_image_cli_writes_the_jax_clis_bytes(tmp_path):
    """cli.binarize_image writes _BIN, _text and _bg PNGs byte for byte as
    the JAX CLI's cv2.imwrite does, from the same image and weights (the
    JAX CLI reads the .msgpack, the port's the .dat made from it)."""
    from lecturemath_tpu.cli import binarize_image as jax_cli
    from lecturemath_tpu.pipeline.binarize import save_checkpoint_variables
    from lecturemath_tpu_torch.cli import binarize_image

    conf = _workspace(tmp_path)
    cfg = jfcn.FCNConfig(**TINY)
    save_checkpoint_variables(jax_threshold_variables(cfg),
                              str(tmp_path / "models" / "tiny.msgpack"))
    image = str(tmp_path / "board.png")
    cv2.imwrite(image, _lecture_frames(70, 50, 1, seed=9)[0][:, :, ::-1])
    binarize_image.main(["binarize_image", conf,
                         str(tmp_path / "models" / "tiny.dat"), image,
                         str(tmp_path / "port"), "-device", "cpu"])
    jax_cli.main(["binarize_image", conf,
                  str(tmp_path / "models" / "tiny.msgpack"), image,
                  str(tmp_path / "jax")])
    for suffix in ("_BIN.png", "_text.png", "_bg.png"):
        ours = (tmp_path / f"port{suffix}").read_bytes()
        assert ours == (tmp_path / f"jax{suffix}").read_bytes(), suffix
    binary = cv2.imread(str(tmp_path / "port_BIN.png"), cv2.IMREAD_GRAYSCALE)
    assert (binary == 0).any() and (binary == 255).any()


def test_serve_cli_device_cpu(tmp_path):
    """cli.serve -device cpu answers /healthz and /binarize, and /reload
    takes a .dat checkpoint; a bad path answers 400 and serving goes on."""
    import subprocess
    import sys

    conf = _workspace(tmp_path)
    blind = tmp_path / "models" / "blind.dat"
    save_checkpoint(threshold_binarizer_variables(NET_CONFIG,
                                                  threshold_gray=5.0),
                    str(blind))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "lecturemath_tpu_torch.cli.serve", conf,
         "-device", "cpu", "-size", "64x48", "-batch", "2", "-port", "0"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "Binarize server at http://" in line, line
        base = line.split()[3].rstrip("/")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.loads(r.read())["device"] == "cpu"
        payload = encode_png(_frame()[:, :, ::-1])
        binary = decode_png_gray(_post(f"{base}/binarize", payload))
        assert (binary[12:18, 14:28] == 0).all()
        answer = json.loads(_post(f"{base}/reload", json.dumps(
            {"checkpoint": str(blind)}).encode()))
        assert answer["ok"]
        binary = decode_png_gray(_post(f"{base}/binarize", payload))
        assert (binary == 255).all()
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            _post(f"{base}/reload", json.dumps(
                {"checkpoint": str(tmp_path / "nope.dat")}).encode())
        assert excinfo.value.code == 400
        binary = decode_png_gray(_post(f"{base}/binarize", payload))
        assert (binary == 255).all()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_a_burst_of_clients_connects_at_once(service):
    """40 clients connecting at once all get through the listen backlog
    before the server accepts any of them (a backlog of 5 made the kernel
    drop the rest, to be retried after 1 s)."""
    import socket

    server = serve(service, port=0)
    sockets = []
    try:
        for _ in range(40):
            sockets.append(socket.create_connection(server.server_address,
                                                    timeout=0.5))
    finally:
        for sock in sockets:
            sock.close()
        server.server_close()
    assert len(sockets) == 40
