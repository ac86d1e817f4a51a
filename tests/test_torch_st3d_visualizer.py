"""The port's ST3D visualizer (utils/st3d_visualizer.py): the JAX
package's tests of its queries (the unique CC under a pixel and the group
covering it) and of its HTTP surface run on the port, over the port's
stage-02/03 computation, and parity with the JAX package: the same
synthetic lecture through both packages' tracker and grouping gives equal
states, views, queries and HTTP answers (PNG bytes included); the session
loads from the port's stage artifacts (``from_artifacts``)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from lecturemath_tpu_torch.utils.st3d_visualizer import (
    ST3DVisualizerSession, serve)

import _torch_editor_scenario as scenario

PACKAGES = ("lecturemath_tpu", "lecturemath_tpu_torch")


@pytest.fixture(scope="module")
def session():
    return scenario.st3d_session("lecturemath_tpu_torch")


def _ink_pixel(session, pos):
    """An ink pixel of the first CC present at sample ``pos``."""
    uidx, cc = session.tracker.cc_idx_per_frame[pos][0]
    ys, xs = np.nonzero(cc.img)
    return uidx, cc, int(xs[0] + cc.min_x), int(ys[0] + cc.min_y)


def test_state_shape(session):
    state = session.state()
    assert state["n_samples"] == 20
    assert state["width"] == 96 and state["height"] == 64
    assert state["n_unique_ccs"] == len(session.tracker.unique_ccs) > 0
    assert state["n_groups"] > 0
    assert state["has_reconstructed"]
    assert state["frame_indices"][1] == 30


def test_frame_image_modes(session):
    for mode in ("binary", "reconstructed", "stable"):
        image = session.frame_image(8, mode)
        assert image.shape == (64, 96, 3) and image.dtype == np.uint8
        assert image.max() > 0, mode
    # binary mode matches the tracker's own rebuilt frames bit for bit
    rebuilt = session.tracker.rebuilt_binary_frames()[8]
    assert (session.frame_image(8, "binary")[:, :, 0] == rebuilt).all()
    # reconstructed mode serves the stage-03 clean frames
    assert (session.frame_image(8, "reconstructed")[:, :, 0]
            == session.clean_frames[8]).all()
    with pytest.raises(IndexError):
        session.frame_image(20, "binary")
    with pytest.raises(ValueError):
        session.frame_image(0, "nope")


def test_reconstructed_mode_without_artifact_is_an_error(session):
    """Serving the rebuilt binary labeled as the stage-03 reconstruction
    would have the user debugging the wrong artifact — refuse instead."""
    bare = ST3DVisualizerSession(session.frame_times, session.frame_indices,
                                 session.tracker, session.st3d,
                                 clean_frames=None)
    assert not bare.state()["has_reconstructed"]
    assert bare.frame_image(3, "binary").shape == (64, 96, 3)
    with pytest.raises(ValueError, match="CC_RECONSTRUCTED_OUTPUT"):
        bare.frame_image(3, "reconstructed")


def test_concurrent_binary_renders(session):
    """The binary-render cache is shared across HTTP handler threads."""
    import concurrent.futures

    fresh = ST3DVisualizerSession(session.frame_times, session.frame_indices,
                                  session.tracker, session.st3d)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        images = list(pool.map(
            lambda pos: fresh.frame_image(pos % 20, "binary"),
            range(200)))
    rebuilt = session.tracker.rebuilt_binary_frames()
    for pos, image in enumerate(images):
        assert (image[:, :, 0] == rebuilt[pos % 20]).all()


def test_query_cc_under_ink_pixel(session):
    pos = 8     # mid-era: glyphs are stable and grouped here
    uidx, cc, x, y = _ink_pixel(session, pos)
    result = session.query(pos, x, y)
    assert result["frame_index"] == session.frame_indices[pos]
    assert result["cc"] is not None
    assert result["cc"]["id"] == uidx
    assert result["cc"]["box"] == [cc.min_x, cc.min_y, cc.max_x, cc.max_y]
    assert result["cc"]["size"] == cc.size
    sightings = session.tracker.unique_cc_frames[uidx]
    assert result["cc"]["instances"] == len(sightings)
    assert result["cc"]["first_frame"] == \
        session.frame_indices[sightings[0][0]]
    # a stable mid-era glyph belongs to a group whose image inks the pixel
    assert result["group"] is not None
    gbox = result["group"]["box"]
    assert gbox[0] <= x <= gbox[2] and gbox[1] <= y <= gbox[3]
    ages = result["group"]["ages"]
    assert ages[0] <= result["frame_index"] <= ages[-1]


def test_query_background_pixel(session):
    result = session.query(8, 0, 0)
    assert result["cc"] is None and result["group"] is None


def test_query_out_of_range(session):
    with pytest.raises(IndexError):
        session.query(99, 0, 0)


def test_query_consistent_with_rendered_views(session):
    """Property: every ink pixel of the rendered binary view must query
    to a CC containing it, and every ink pixel of the stable-group view
    to a group whose box contains it (sampled grid, several frames)."""
    for pos in (2, 8, 14, 19):
        binary = session.frame_image(pos, "binary")[:, :, 0]
        stable = session.frame_image(pos, "stable")[:, :, 0]
        ys, xs = np.nonzero(binary)
        for y, x in list(zip(ys.tolist(), xs.tolist()))[::37]:
            result = session.query(pos, x, y)
            assert result["cc"] is not None, (pos, x, y)
            box = result["cc"]["box"]
            assert box[0] <= x <= box[2] and box[1] <= y <= box[3]
        ys, xs = np.nonzero(stable)
        for y, x in list(zip(ys.tolist(), xs.tolist()))[::41]:
            result = session.query(pos, x, y)
            assert result["group"] is not None, (pos, x, y)
            gbox = result["group"]["box"]
            assert gbox[0] <= x <= gbox[2] and gbox[1] <= y <= gbox[3]


def test_http_surface(session):
    server = serve(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    base = f"http://{host}:{port}"
    try:
        page = urllib.request.urlopen(f"{base}/").read().decode()
        assert "ST3D visualizer" in page

        state = json.loads(urllib.request.urlopen(
            f"{base}/api/state").read())
        assert state["lecture"] == "viz01" and state["n_samples"] == 20

        png = urllib.request.urlopen(
            f"{base}/img/frame/8.png?mode=stable").read()
        assert png[:4] == b"\x89PNG"

        _, _, x, y = _ink_pixel(session, 8)
        query = json.loads(urllib.request.urlopen(
            f"{base}/api/query?pos=8&x={x}&y={y}").read())
        assert query["cc"] is not None

        for bad in ("/img/frame/999.png", "/api/query?pos=0&x=a&y=0",
                    "/nope"):
            with pytest.raises(urllib.error.HTTPError) as excinfo:
                urllib.request.urlopen(base + bad)
            assert excinfo.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


# ------------------------------------------------- parity with the JAX package

@pytest.fixture(scope="module")
def jax_session():
    return scenario.st3d_session("lecturemath_tpu")


def test_state_equals_jax(session, jax_session):
    assert session.state() == jax_session.state()


@pytest.mark.parametrize("mode", ["binary", "reconstructed", "stable"])
def test_frame_images_equal_jax(session, jax_session, mode):
    for pos in range(session.n_samples):
        np.testing.assert_array_equal(session.frame_image(pos, mode),
                                      jax_session.frame_image(pos, mode))


def test_queries_equal_jax(session, jax_session):
    """The query of every 7th ink pixel of the binary and stable views of
    four samples, and of background pixels, equals the JAX session's."""
    hits = 0
    for pos in (2, 8, 14, 19):
        for mode in ("binary", "stable"):
            view = session.frame_image(pos, mode)[:, :, 0]
            ys, xs = np.nonzero(view)
            for y, x in list(zip(ys.tolist(), xs.tolist()))[::7] + [(0, 0)]:
                ours = session.query(pos, x, y)
                assert ours == jax_session.query(pos, x, y), (pos, x, y)
                hits += ours["cc"] is not None
    assert hits > 50


def _answers(session_):
    server = serve(session_, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    answers = []
    try:
        paths = ["/", "/api/state"]
        paths += [f"/img/frame/{pos}.png?mode={mode}" for pos in (0, 8, 19)
                  for mode in ("binary", "reconstructed", "stable")]
        paths += ["/api/query?pos=8&x=40&y=30", "/api/query?pos=3&x=0&y=0",
                  "/img/frame/999.png", "/api/query?pos=0&x=a&y=0"]
        _, _, x, y = _ink_pixel(session_, 8)
        paths.append(f"/api/query?pos=8&x={x}&y={y}")
        for path in paths:
            try:
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    answers.append(r.read())
            except urllib.error.HTTPError as err:
                answers.append(err.code)
    finally:
        server.shutdown()
        server.server_close()
    return answers


def test_http_answers_equal_jax(session, jax_session):
    """The page, the state, every view's PNG bytes, the queries and the
    404s of the two servers are equal."""
    ours, theirs = _answers(session), _answers(jax_session)
    assert ours == theirs
    assert sum(isinstance(a, bytes) and a[:4] == b"\x89PNG"
               for a in ours) == 9
    assert ours.count(404) == 2


def test_from_artifacts_over_the_port_store(session, tmp_path):
    """from_artifacts loads the stage-02/03 artifacts the port's store
    relays (the tracker, the ST3D structure and the PNG-compressed
    reconstructed frames) into a session equal to the in-memory one."""
    from lecturemath_tpu_torch.core.artifacts import ArtifactStore
    from lecturemath_tpu_torch.pipeline.video import compress_png

    store = ArtifactStore(str(tmp_path))
    store.save((session.frame_times, session.frame_indices,
                session.tracker), "stability", "viz01")
    store.save(session.st3d, "st3d", "viz01")
    store.save((session.frame_times, session.frame_indices,
                compress_png(session.clean_frames)), "reconstructed",
               "viz01")
    loaded = ST3DVisualizerSession.from_artifacts(
        store, "viz01", "stability", "st3d", "reconstructed",
        lecture="viz01")
    assert loaded.state() == session.state()
    for pos in (0, 8, 19):
        for mode in ("binary", "reconstructed", "stable"):
            np.testing.assert_array_equal(loaded.frame_image(pos, mode),
                                          session.frame_image(pos, mode))
    _, _, x, y = _ink_pixel(session, 8)
    assert loaded.query(8, x, y) == session.query(8, x, y)
