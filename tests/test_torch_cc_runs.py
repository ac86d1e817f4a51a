"""The port's CC extraction by runs of ink (``native.label_runs``, the fast
route of ``data/cc.py extract_ccs``) against its scipy fallback and the JAX
package's ``extract_ccs``: the same CCs in the same order, with the same ids,
boxes, sizes, ages and crop bytes; the route counter ``extract_stats``; the
call run from several threads at once; crops that own their memory."""

import sys
import threading

import numpy as np
import pytest
from scipy import ndimage

from lecturemath_tpu.data.cc import extract_ccs as jax_extract_ccs
from lecturemath_tpu_torch import native
from lecturemath_tpu_torch.data.cc import extract_ccs, extract_stats
from lecturemath_tpu_torch.utils.synthetic import synthetic_lecture


@pytest.fixture(autouse=True)
def native_library():
    assert native.available()


def blobs(seed, h, w, density=0.2):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)) < density
    return ndimage.binary_dilation(img).astype(np.uint8) * 255


def lattice(h, w):
    """Isolated single pixels: every other pixel of every other row."""
    frame = np.zeros((h, w), np.uint8)
    frame[::2, ::2] = 255
    return frame


def border_blobs():
    """5x5 blocks touching each edge and each corner, and one inside."""
    frame = np.zeros((40, 53), np.uint8)
    for y, x in [(0, 0), (0, 24), (0, 48), (17, 0), (17, 48), (35, 0),
                 (35, 24), (35, 48), (17, 24)]:
        frame[y:y + 5, x:x + 5] = 255
    return frame


def diagonal_blocks():
    """5x5 blocks meeting only at corners, and a checkerboard: diagonal
    contact joins nothing under 4-connectivity."""
    frame = np.zeros((45, 70), np.uint8)
    for k in range(7):
        frame[5 * k:5 * k + 5, 5 * k:5 * k + 5] = 255
    frame[36:44, 40:67] = (np.indices((8, 27)).sum(0) % 2 * 255)
    return frame


def u_shapes():
    """A U whose arms join rows below their tops, an upside-down U, and a
    ring holding a dot inside its box."""
    frame = np.zeros((36, 61), np.uint8)
    frame[2:20, 3:6] = 255
    frame[2:20, 14:17] = 255
    frame[17:20, 3:17] = 255
    frame[4:7, 22:40] = 255
    frame[4:24, 22:25] = 255
    frame[4:24, 37:40] = 255
    frame[22:35, 44:60] = 255
    frame[25:32, 47:57] = 0
    frame[27:30, 50:54] = 255
    return frame


def comb():
    """Teeth starting on different rows, joined by a bar at the bottom, the
    later-labelled teeth to the left: the unions come rows after the first
    runs and must merge under the lowest (first) run."""
    frame = np.zeros((30, 67), np.uint8)
    for k, x in enumerate(range(1, 62, 4)):
        frame[(k * 7) % 19:25, x:x + 2] = 255
    frame[25:28, 1:63] = 255
    return frame


def spiral(n=41):
    """One square spiral with one-pixel gaps between its arms: a long
    component whose runs join over many rows."""
    frame = np.zeros((n, n), np.uint8)
    y = x = 0
    frame[0, 0] = 255
    steps = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    lengths = [n - 1, n - 1, n - 1] + [n - 1 - 2 * (k // 2 + 1)
                                       for k in range(2 * n)]
    for k, length in enumerate(lengths):
        if length <= 0:
            break
        dy, dx = steps[k % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            frame[y, x] = 255
    return frame


def words_crossed():
    """Bars of 19 and 9 columns 6 rows high, 3 and 5 columns apart, their
    edges at every offset within a machine word; width 137."""
    period = np.array([0] * 5 + [255] * 19 + [0] * 3 + [255] * 9, np.uint8)
    return np.repeat(np.tile(period, 4)[None, :137], 6, axis=0)


def board(seed, height, width, glyph_size, jitter, t):
    frames, _, _ = synthetic_lecture(seed=seed, n_frames=24, height=height,
                                     width=width, n_boards=2,
                                     glyphs_per_board=12, jitter=jitter,
                                     glyph_size=glyph_size)
    return frames[t]


FRAMES = {
    "empty": lambda: np.zeros((37, 53), np.uint8),
    "all_ink": lambda: np.full((30, 41), 255, np.uint8),
    "one_pixel_frame": lambda: np.full((1, 1), 255, np.uint8),
    "single_pixels": lambda: lattice(21, 27),
    "borders": border_blobs,
    "diagonal": diagonal_blocks,
    "u_shapes": u_shapes,
    "comb": comb,
    "spiral": spiral,
    "ones_not_255": lambda: blobs(3, 50, 61) // 255,
    "width_1": lambda: blobs(4, 64, 1, 0.4),
    "width_7": lambda: blobs(5, 48, 7, 0.3),
    "width_9": lambda: blobs(6, 48, 9, 0.3),
    "width_31": lambda: blobs(7, 40, 31),
    "width_33": lambda: blobs(8, 40, 33),
    "width_65": lambda: blobs(9, 40, 65, 0.1),
    "width_127": lambda: blobs(10, 33, 127, 0.05),
    "runs_across_words": lambda: words_crossed(),
    "board_small": lambda: board(0, 96, 128, (16, 20), 0.0, 10),
    "board_jitter": lambda: board(1, 96, 128, (16, 20), 0.1, 20),
    "board_540p": lambda: board(2, 540, 960, (40, 60), 0.0, 9),
    "board_540p_jitter": lambda: board(3, 540, 957, (40, 60), 0.05, 21),
}


def ages_for(frame, seed=0):
    """float32 ages, so that the fallback's minimum equals the native
    call's float32 one."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, frame.shape).astype(np.float32) / 8


def rows(ccs):
    return [(cc.cc_id, cc.min_x, cc.max_x, cc.min_y, cc.max_y, cc.size,
             cc.start_time, cc.end_time, cc.img.shape, cc.img.dtype.str,
             cc.img.tobytes()) for cc in ccs]


def test_the_runs_frames_are_what_they_claim():
    """The hand-made frames hold what their names say, by scipy."""
    def n_labels(frame):
        return ndimage.label(frame)[1]

    assert n_labels(FRAMES["diagonal"]()) == 7 + 8 * 27 // 2
    assert n_labels(FRAMES["u_shapes"]()) == 4
    assert n_labels(FRAMES["comb"]()) == 1
    assert n_labels(FRAMES["spiral"]()) == 1
    assert n_labels(FRAMES["borders"]()) == 9
    assert n_labels(FRAMES["single_pixels"]()) == 11 * 14
    assert n_labels(FRAMES["runs_across_words"]()) == 8


@pytest.mark.parametrize("with_ages", [False, True])
@pytest.mark.parametrize("filter_small", [True, False])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_runs_equal_scipy_and_jax(name, filter_small, with_ages):
    frame = FRAMES[name]()
    ages = ages_for(frame) if with_ages else None
    before = dict(extract_stats)
    runs = extract_ccs(frame, ages, filter_small=filter_small)
    assert extract_stats["frames_runs"] == before["frames_runs"] + 1
    fallback = extract_ccs(frame, ages, filter_small=filter_small,
                           use_native=False)
    reference = jax_extract_ccs(frame, ages, filter_small=filter_small)
    assert rows(runs) == rows(fallback) == rows(reference)
    if name == "all_ink":
        assert len(runs) == 1 and runs[0].size == frame.size
    if name == "empty":
        assert runs == []


def test_crops_leave_other_components_inside_the_box_at_zero():
    """The ring's crop holds the dot's box, but not the dot."""
    ring = [cc for cc in extract_ccs(u_shapes())
            if (cc.min_x, cc.min_y) == (44, 22)]
    assert len(ring) == 1
    inside = ring[0].img[27 - 22:30 - 22, 50 - 44:54 - 44]
    assert not inside.any()


def test_label_runs_returns_the_runs_and_the_order():
    frame = comb()
    n_found, n_runs, stats, min_ages, crops = native.label_runs(frame)
    expected_runs = sum(
        int(np.count_nonzero(np.diff(np.concatenate(([0], row > 0, [0])))
                             == 1)) for row in frame)
    assert (n_found, n_runs) == (1, expected_runs)
    assert min_ages is None
    assert stats.tolist() == [[1, 62, 0, 27, int((frame > 0).sum())]]
    assert crops.size == 62 * 28


def test_past_max_components_only_the_first_get_stats():
    """Every component counts; the first ``max_components`` in raster order
    get stats and crops, and the crops left out are the filtered ones."""
    frame = blobs(11, 60, 80)
    labels, n_labels = ndimage.label(frame)
    boxes = ndimage.find_objects(labels)
    sizes = np.bincount(labels.ravel())[1:]
    n_found, _, stats, _, crops = native.label_runs(frame, min_pixels=6,
                                                    max_components=5)
    assert n_found == n_labels > 5 and len(stats) == 5
    expected = [[sx.start, sx.stop - 1, sy.start, sy.stop - 1, sizes[k]]
                for k, (sy, sx) in enumerate(boxes[:5])]
    assert stats.tolist() == expected
    assert crops.size == sum((sy.stop - sy.start) * (sx.stop - sx.start)
                             for k, (sy, sx) in enumerate(boxes[:5])
                             if sizes[k] >= 6)


def test_a_frame_past_65536_components():
    """A frame of 90,000 single pixels: the first 65,536 listed, as the JAX
    package's native route and scipy's first 65,536 give them."""
    frame = lattice(600, 600)
    before = dict(extract_stats)
    runs = extract_ccs(frame, filter_small=False)
    assert extract_stats["ccs"] - before["ccs"] == 300 * 300
    assert extract_stats["runs"] - before["runs"] == 300 * 300
    assert len(runs) == 1 << 16
    assert rows(runs) == rows(jax_extract_ccs(frame, filter_small=False))
    fallback = extract_ccs(frame, filter_small=False, use_native=False)
    assert rows(runs) == rows(fallback[:1 << 16])


@pytest.mark.parametrize("route", ["runs", "no_native", "labels_given"])
def test_extract_stats_counts_each_route(route, monkeypatch):
    frame = FRAMES["u_shapes"]()
    before = dict(extract_stats)
    if route == "no_native":
        monkeypatch.setattr(native, "available", lambda: False)
        ccs = extract_ccs(frame)
    elif route == "labels_given":
        labels, n_labels = ndimage.label(frame)
        ccs = extract_ccs(None, labels=labels, n_labels=n_labels)
    else:
        ccs = extract_ccs(frame)
    assert len(ccs) == 3
    delta = {key: extract_stats[key] - before[key] for key in extract_stats}
    # the U's arms start as two runs a row for 15 rows, then one run for 3
    # rows; the upside-down U one run for 3 rows, then two for 17; the ring
    # one run for 3 rows, two for 7, one for 3, with the dot's three runs
    n_runs = (2 * 15 + 3) + (3 + 2 * 17) + (3 + 2 * 7 + 3 + 3)
    if route == "runs":
        assert delta == {"frames_runs": 1, "frames_scipy": 0,
                         "runs": n_runs, "ccs": 4}
    else:
        assert delta == {"frames_runs": 0, "frames_scipy": 1, "runs": 0,
                         "ccs": 4}


@pytest.mark.parametrize("n_threads", [2, 8])
def test_threads_labelling_at_once_get_their_own_results(n_threads):
    """The call keeps no state: threads extracting different frames at once
    each get the result the frame gives alone, and the counter loses no
    frame."""
    frames = [board(seed, 96, 128, (16, 20), 0.05, 5 + seed)
              for seed in range(n_threads)]
    expected = [rows(extract_ccs(frame)) for frame in frames]
    rounds = 40
    start = threading.Barrier(n_threads)
    results = [[] for _ in range(n_threads)]
    before = extract_stats["frames_runs"]

    def work(k):
        start.wait(timeout=30)
        for _ in range(rounds):
            results[k].append(rows(extract_ccs(frames[k])))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    for k in range(n_threads):
        assert len(results[k]) == rounds
        assert all(result == expected[k] for result in results[k])
    assert extract_stats["frames_runs"] - before == n_threads * rounds


@pytest.mark.parametrize("name", ["board_540p", "u_shapes", "all_ink"])
def test_a_kept_crop_owns_its_memory(name):
    """A CC's crop holds no buffer of the frame or of its other CCs alive:
    it owns its bytes or views no more than its own crop."""
    ccs = extract_ccs(FRAMES[name]())
    assert ccs
    for cc in ccs:
        assert cc.img.flags.c_contiguous and cc.img.dtype == np.uint8
        assert cc.img.shape == (cc.height, cc.width)
        assert cc.img.base is None or cc.img.base.nbytes <= cc.img.nbytes


def test_label_runs_refuses_ages_of_another_shape():
    frame = u_shapes()
    with pytest.raises(ValueError):
        native.label_runs(frame, np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        native.label_runs(frame[None])
