"""The port's region data (data/region_tree.py, data/content_region.py)
against the JAX package's and OpenCV: the CC boxes of ``RegionCCs.from_binary``
equal ``cv2.connectedComponentsWithStats`` (8-connected) in value and order
with cv2 unimportable for the port, the XY-cut segmentation is the JAX
package's, and the XML is byte-identical in both directions."""

import pickle
import sys

import cv2
import numpy as np
import pytest

from lecturemath_tpu.data.content_region import ContentRegion as JaxRegion
from lecturemath_tpu.data.region_tree import RegionCCs as JaxCCs
from lecturemath_tpu.data.region_tree import RegionTree as JaxTree
from lecturemath_tpu_torch.data.content_region import ContentRegion
from lecturemath_tpu_torch.data.region_tree import RegionCCs, RegionTree


@pytest.fixture
def no_cv2(monkeypatch):
    """Call to make cv2 and PIL unimportable for the rest of the test (the
    references are computed before)."""
    def block():
        for name in list(sys.modules):
            if name.split(".")[0] in ("cv2", "PIL"):
                monkeypatch.delitem(sys.modules, name)
        for name in ("cv2", "PIL"):
            monkeypatch.setitem(sys.modules, name, None)
    return block


def random_binary(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 90, 2))
    density = rng.uniform(0.02, 0.6)
    return (rng.random((h, w)) < density).astype(np.uint8) * 255


def page(seed):
    """Text-like lines and blocks on a blank page: rows of glyph boxes with
    gaps, in two columns."""
    rng = np.random.default_rng(seed)
    img = np.zeros((160, 240), np.uint8)
    for column in (0, 1):
        x0 = 8 + column * 125
        for line in range(int(rng.integers(2, 6))):
            y = 10 + line * 28
            x = x0
            while x < x0 + 100:
                w, h = int(rng.integers(3, 12)), int(rng.integers(8, 16))
                img[y:y + h, x:x + w] = 255
                x += w + int(rng.integers(2, 8))
    return img


def test_region_ccs_equal_cv2_8_connected(no_cv2):
    binaries = [random_binary(seed) for seed in range(120)]
    binaries += [page(seed) for seed in range(4)]
    binaries += [np.zeros((7, 9), np.uint8), np.full((5, 4), 255, np.uint8),
                 np.eye(12, dtype=np.uint8) * 255,          # diagonal: one CC
                 np.fliplr(np.eye(12, dtype=np.uint8)) * 7]  # any nonzero
    want = []
    for binary in binaries:
        _, _, stats, _ = cv2.connectedComponentsWithStats(binary, 8,
                                                          cv2.CV_32S)
        want.append(stats[1:, :5])
    no_cv2()
    for binary, stats in zip(binaries, want):
        got = RegionCCs.from_binary(binary).bboxes
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, stats.reshape(-1, 5))


def test_region_ccs_helpers_equal_jax():
    bboxes = np.array([[5, 10, 20, 8, 160], [40, 2, 10, 30, 300]])
    ours, theirs = RegionCCs(bboxes), JaxCCs(bboxes)
    assert ours.enclosing_bbox(100, 100, margin=2) == \
        theirs.enclosing_bbox(100, 100, margin=2) == (3, 0, 49, 34)
    np.testing.assert_array_equal(
        ours.filtered_to((0, 30), (0, 50)).bboxes,
        theirs.filtered_to((0, 30), (0, 50)).bboxes)
    assert RegionCCs().enclosing_bbox(10, 10) is None
    assert len(RegionCCs.from_binary(np.zeros((3, 3), np.uint8))) == 0


def _leaves(tree):
    return [(n.x_limits, n.y_limits, n.ccs.bboxes.tolist())
            for n in tree.leaves()]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("alphas", [(-1.25, -3.0), (0.0, 0.0)])
def test_segmentation_and_xml_equal_jax(seed, alphas):
    binary = page(seed)
    ours = RegionTree.from_binary(binary)
    theirs = JaxTree.from_binary(binary)
    ours.segment_recursive(*alphas)
    theirs.segment_recursive(*alphas)
    assert _leaves(ours) == _leaves(theirs)
    xml = ours.to_xml_string()
    assert xml == theirs.to_xml_string()

    # each package reads the other's XML back to the same tree and XML
    from_jax = RegionTree.from_xml_string(theirs.to_xml_string(), binary)
    from_port = JaxTree.from_xml_string(xml, binary)
    assert from_jax.to_xml_string() == xml
    assert from_port.to_xml_string() == xml
    assert _leaves(from_jax) == _leaves(theirs)
    for x, y in ((10, 15), (130, 40), (200, 120), (0, 0)):
        mine, other = ours.find_region(x, y), theirs.find_region(x, y)
        assert (mine is None) == (other is None)
        if mine is not None:
            assert (mine.x_limits, mine.y_limits) == (other.x_limits,
                                                      other.y_limits)


def test_forced_cuts_equal_jax():
    binary = page(7)
    ours, theirs = RegionTree.from_binary(binary), JaxTree.from_binary(binary)
    for tree in (ours, theirs):
        tree.root.force_segment_y(70)
        tree.root.left.force_segment_x(120)
    assert ours.to_xml_string() == theirs.to_xml_string()
    assert _leaves(ours) == _leaves(theirs)


@pytest.mark.parametrize("channels", [None, 3])
def test_content_region_round_trip(tmp_path, channels, no_cv2, monkeypatch):
    rng = np.random.default_rng(4)
    shape = (8, 10) if channels is None else (8, 10, channels)
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    region = ContentRegion(3, 1.0, 2.0, 0.0, 0, None, None,
                           (0, 0, 10, 8), image, name="r3")
    jax_out = str(tmp_path / "jax.png")
    JaxRegion(3, 1.0, 2.0, 0.0, 0, None, None, (0, 0, 10, 8),
              image).save_image(jax_out)
    no_cv2()
    out = str(tmp_path / "region.png")
    region.save_image(out)
    assert region.components == [] and region.content is None
    with open(out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    monkeypatch.undo()
    flag = (cv2.IMREAD_GRAYSCALE if channels is None else cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv2.imread(out, flag), image)
    # the region pickles (data kept against it keeps a loading surface)
    restored = pickle.loads(pickle.dumps(region))
    np.testing.assert_array_equal(restored.image, image)
    assert (restored.id, restored.box, restored.name) == (3, (0, 0, 10, 8),
                                                          "r3")
