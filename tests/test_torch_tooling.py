"""The port's lecture tooling against the JAX package's on the same seeded
inputs: the geometry helpers, the binary video export (interpolated_frames,
the rendered frame PNGs, the export_video CLI), the video metrics (counts
and CLI on an MJPG AVI written by OpenCV), the headless visualizer and the
vis_gt_intervals CLI, and the dataset-prep CLIs (prepare_text_masks,
prepare_cocotext, validate_dataset). Outputs are equal (==, byte for byte
for files, identical stdout); the plot is compared by its decoded pixels."""

import contextlib
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest

import lecturemath_tpu.cli.export_video as jax_export_cli
import lecturemath_tpu.cli.prepare_cocotext as jax_cocotext
import lecturemath_tpu.cli.prepare_text_masks as jax_text_masks
import lecturemath_tpu.cli.validate_dataset as jax_validate
import lecturemath_tpu.cli.video_metrics as jax_metrics_cli
import lecturemath_tpu.cli.vis_gt_intervals as jax_vis_cli
import lecturemath_tpu.pipeline.export_video as jax_export
import lecturemath_tpu.pipeline.video_metrics as jax_vm
import lecturemath_tpu.utils.geometry as jax_geometry
import lecturemath_tpu.utils.visualizer as jax_visualizer
from lecturemath_tpu.data.cc import CC as JaxCC
from lecturemath_tpu.data.space_time import SpaceTimeStruct as JaxST3D
import lecturemath_tpu_torch.cli.export_video as export_cli
import lecturemath_tpu_torch.cli.prepare_cocotext as cocotext
import lecturemath_tpu_torch.cli.prepare_text_masks as text_masks
import lecturemath_tpu_torch.cli.validate_dataset as validate
import lecturemath_tpu_torch.cli.video_metrics as metrics_cli
import lecturemath_tpu_torch.cli.vis_gt_intervals as vis_cli
import lecturemath_tpu_torch.pipeline.export_video as export
import lecturemath_tpu_torch.pipeline.video_metrics as vm
import lecturemath_tpu_torch.utils.geometry as geometry
import lecturemath_tpu_torch.utils.visualizer as visualizer
from lecturemath_tpu_torch.core.artifacts import ArtifactStore
from lecturemath_tpu_torch.data.cc import CC
from lecturemath_tpu_torch.data.space_time import SpaceTimeStruct
from lecturemath_tpu_torch.eval.lecture_annotation import LectureAnnotation
from lecturemath_tpu_torch.pipeline.video import compress_png
from lecturemath_tpu_torch.utils.png import decode_png_color, encode_png

DB = "TLDB"
LECTURE = "tl01"
H, W = 36, 52
FPS = 30.0
VIDEO_FRAMES = 12


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _tree(root):
    """{relative path: bytes} of every file under root."""
    files = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


# ------------------------------------------------------------- geometry

def _segments(rng, n):
    """Integer segments (vertical, level, collinear and crossing cases all
    occur) and a few fractional ones."""
    ints = rng.integers(0, 6, (n, 4)).astype(float)
    fracs = rng.uniform(-3, 8, (n // 4, 4))
    return [((a, b), (c, d)) for a, b, c, d in np.concatenate([ints, fracs])]


@pytest.mark.parametrize("seed", range(3))
def test_geometry_equals_jax(seed):
    rng = np.random.default_rng(seed)
    segments = _segments(rng, 60)
    for a in segments:
        for b in segments[:25]:
            ours = geometry.LineSegment2D(*a).intersection(
                geometry.LineSegment2D(*b))
            theirs = jax_geometry.LineSegment2D(*a).intersection(
                jax_geometry.LineSegment2D(*b))
            assert ours == theirs, (a, b)
            assert geometry.lines_intersect(a, b) == \
                jax_geometry.lines_intersect(a, b)
        assert geometry.line_boundaries(*a) == \
            jax_geometry.line_boundaries(*a)
    for _ in range(30):
        polygon = [tuple(p) for p in rng.integers(0, 8, (5, 2)).astype(float)]
        line = segments[int(rng.integers(len(segments)))]
        assert geometry.line_intersects_polygon(line, polygon) == \
            jax_geometry.line_intersects_polygon(line, polygon)
    boxes = [((x0, x0 + w), (y0, y0 + h)) for x0, w, y0, h in
             rng.integers(-2, 6, (20, 4))]
    assert geometry.boxes_bounding_box(boxes) == \
        jax_geometry.boxes_bounding_box(boxes)
    for a in boxes:
        for b in boxes:
            assert geometry.boxes_intersect(a, b) == \
                jax_geometry.boxes_intersect(a, b)
            assert geometry.boxes_intersect_reference(a, b) == \
                jax_geometry.boxes_intersect_reference(a, b)


# ---------------------------------------------------------- video export

def _binaries(seed, n):
    rng = np.random.default_rng(seed)
    return [np.where(rng.random((H, W)) < 0.2, 255, 0).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("start,count,skip", [
    (0, 40, 0), (0, 40, 2), (3, 11, 0), (17, 30, 1), (35, 9, 0),
    (38, 5, 3), (2, 1, 0)])
def test_interpolated_frames_equal_jax(start, count, skip):
    """Before the first sample, between samples (every frame, and refreshed
    every skip + 1), on samples and past the last one."""
    frames = _binaries(0, 6)
    indices = [2, 5, 13, 14, 30, 37]
    ours = list(export.interpolated_frames(frames, indices, start, count,
                                           skip))
    theirs = list(jax_export.interpolated_frames(frames, indices, start,
                                                 count, skip))
    assert [i for i, _ in ours] == [i for i, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    for idx, frame in ours:
        if idx in indices:
            assert np.array_equal(frame, frames[indices.index(idx)])


def _video(path, n=VIDEO_FRAMES):
    """An MJPG AVI of n seeded frames, written by OpenCV."""
    rng = np.random.default_rng(5)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                             (W, H))
    assert writer.isOpened()
    for _ in range(n):
        writer.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """db.xml, a config, the stage-01 artifact of lecture tl01 (frames
    sampled at 0, 3, ..., 27), its video (an MJPG AVI) and its
    LectureAnnotation XML."""
    root = str(tmp_path_factory.mktemp("tooling"))
    with open(os.path.join(root, "db.xml"), "w") as f:
        f.write(f"""<AccessMath><DataBase><Name>{DB}</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Testing><LectureTitle>{LECTURE}</LectureTitle></Testing></Datasets>
<Lectures><Lecture><Id>{LECTURE}</Id><Title>{LECTURE}</Title><Parameters>
</Parameters><Videos><Main><Video><Path>{LECTURE}.avi</Path></Video></Main>
</Videos></Lecture></Lectures></DataBase></AccessMath>
""")
    conf = os.path.join(root, "tooling.conf")
    with open(conf, "w") as f:
        f.write(f"VIDEO_DATABASE_PATH = {root}/db.xml\n"
                f"VIDEO_FILES_PATH = {root}/videos\n"
                f"OUTPUT_PATH = {root}/output\n"
                "BINARIZATION_OUTPUT = tempo_binary_\n")
    os.makedirs(os.path.join(root, "videos"))
    _video(os.path.join(root, "videos", f"{LECTURE}.avi"))
    indices = list(range(0, 30, 3))
    frames = _binaries(1, len(indices))
    ArtifactStore(os.path.join(root, "output", "temporal")).save(
        ([i / FPS for i in indices], indices, compress_png(frames)),
        "tempo_binary_", LECTURE)
    annotation = LectureAnnotation(DB, LECTURE, "x.xml", [f"{LECTURE}.avi"],
                                   30)
    annotation.video_segments = [10, 21]
    os.makedirs(os.path.join(root, "output", "annotations"))
    annotation.save(os.path.join(root, "output", "annotations",
                                 f"{DB}_{LECTURE}.xml"))
    return root, conf, indices, frames


@pytest.mark.parametrize("extra", [[], ["-invert", "1"], ["-interp", "2"]])
def test_export_video_cli_equals_jax(workspace, monkeypatch, extra):
    """The CLI's stdout and every rendered frame PNG byte for byte (the
    frames are kept by making removal a no-op for both runs), the video
    read back with the same frame count. ffmpeg is hidden from both, so
    both write through OpenCV's VideoWriter."""
    root, conf, indices, frames = workspace
    out = os.path.join(root, "export", "tl01.mp4")
    frames_dir = out + "_frames"
    argv = ["export_video", conf, "-l", LECTURE, "-o", out, "-fps", "30",
            *extra]
    monkeypatch.setattr(os, "remove", lambda path: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    results = []
    for main in (jax_export_cli.main, export_cli.main):
        shutil.rmtree(os.path.join(root, "export"), ignore_errors=True)
        text = _stdout(main, argv)
        capture = cv2.VideoCapture(out)
        count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        capture.release()
        results.append((text, _tree(frames_dir), count))
    assert results[0][0] == results[1][0]
    assert f"Exported <{LECTURE}> -> {out}" in results[1][0]
    assert results[0][1] == results[1][1]
    assert len(results[1][1]) == indices[-1] + 1
    assert results[0][2] == results[1][2] == indices[-1] + 1


def test_export_renders_sampled_frames(workspace, tmp_path, monkeypatch):
    """Each sampled index's rendered PNG (kept by making removal a no-op)
    is the artifact's binary in every channel."""
    root, conf, indices, frames = workspace
    out = str(tmp_path / "kept.mp4")
    monkeypatch.setattr(os, "remove", lambda path: None)
    export.export_binary_video(
        ArtifactStore(os.path.join(root, "output", "temporal")),
        "tempo_binary_", type("Lecture", (), {"id": LECTURE})(),
        [os.path.join(root, "videos", f"{LECTURE}.avi")], out, fps=FPS)
    for idx, frame in zip(indices, frames):
        with open(str(tmp_path / "kept.mp4_frames" / f"{idx}.png"),
                  "rb") as f:
            rgb = decode_png_color(f.read())
        assert np.array_equal(rgb, np.repeat(frame[:, :, None], 3, axis=2))


def test_export_reads_the_source_fps(workspace, tmp_path, monkeypatch):
    """Without -fps the frame rate comes from the source video (OpenCV),
    as in the JAX package (ffmpeg hidden: the video through OpenCV)."""
    root, conf, indices, _ = workspace
    monkeypatch.setattr(shutil, "which", lambda name: None)
    store = ArtifactStore(os.path.join(root, "output", "temporal"))
    lecture = type("Lecture", (), {"id": LECTURE})()
    video = os.path.join(root, "videos", f"{LECTURE}.avi")
    for module, name in ((jax_export, "jax.mp4"), (export, "port.mp4")):
        module.export_binary_video(store, "tempo_binary_", lecture, [video],
                                   str(tmp_path / name))
        capture = cv2.VideoCapture(str(tmp_path / name))
        assert capture.get(cv2.CAP_PROP_FPS) == pytest.approx(FPS)
        assert int(capture.get(cv2.CAP_PROP_FRAME_COUNT)) == indices[-1] + 1
        capture.release()
    assert not os.path.exists(str(tmp_path / "port.mp4_frames"))


# --------------------------------------------------------- video metrics

def test_video_metrics_equal_jax(workspace):
    root, _, _, _ = workspace
    videos = [os.path.join(root, "videos", f"{LECTURE}.avi")] * 2
    ours = vm.VideoMetrics.from_video_files(videos)
    theirs = jax_vm.VideoMetrics.from_video_files(videos)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.per_video_frames == [VIDEO_FRAMES] * 2
    assert ours.metrics_table() == theirs.metrics_table()
    rows = vm.container_header_metrics(videos)
    assert rows == jax_vm.container_header_metrics(videos)
    assert vm.header_table(rows) == jax_vm.header_table(rows)


def test_video_metrics_cli_equals_jax(workspace):
    root, conf, _, _ = workspace
    out = os.path.join(root, "metrics.json")
    texts, dumps = [], []
    for main in (jax_metrics_cli.main, metrics_cli.main):
        texts.append(_stdout(main, ["video_metrics", conf, "-l", LECTURE,
                                    "-json", out]))
        with open(out) as f:
            dumps.append(json.load(f))
    assert texts[0] == texts[1]
    assert dumps[0] == dumps[1]
    assert dumps[1][LECTURE]["total_frames"] == VIDEO_FRAMES


# ------------------------------------------------------------ visualizer

def _ccs(package_cc, seed, n=6):
    rng = np.random.default_rng(seed)
    ccs = []
    for k in range(n):
        h, w = (int(v) for v in rng.integers(1, 9, 2))
        y, x = int(rng.integers(-3, H - 2)), int(rng.integers(-3, W - 2))
        img = np.where(rng.random((h, w)) < 0.6, 255, 0).astype(np.uint8)
        ccs.append(package_cc(k, x, x + w - 1, y, y + h - 1,
                              int((img > 0).sum()), img))
    return ccs


@pytest.mark.parametrize("disp", [(0, 0), (3, -2), (-5, 4), (51, -35)])
def test_visualizer_images_equal_jax(disp):
    first, second = _binaries(2, 2)
    assert np.array_equal(
        visualizer.combine_binary_images(first, second, *disp),
        jax_visualizer.combine_binary_images(first, second, *disp))
    assert np.array_equal(
        visualizer.combine_binary_images(first, second, *disp, 255),
        jax_visualizer.combine_binary_images(first, second, *disp, 255))
    ours = [_ccs(CC, s) for s in range(3)]
    theirs = [_ccs(JaxCC, s) for s in range(3)]
    assert np.array_equal(visualizer.gt_match_image(H, W, *ours),
                          jax_visualizer.gt_match_image(H, W, *theirs))

    class Match:
        def __init__(self, a, b):
            self.frame1_ccs, self.frame2_ccs = a, b

    def matched(ccs):
        return [Match(ccs[0][:3], ccs[1][:3])], [Match(ccs[0][3:],
                                                       ccs[2][3:])]
    assert np.array_equal(
        visualizer.keyframe_match_image(H, W, *matched(ours), ours[1],
                                        ours[2], *disp),
        jax_visualizer.keyframe_match_image(H, W, *matched(theirs),
                                            theirs[1], theirs[2], *disp))


@pytest.mark.parametrize("frame_pos", [0, 4, 9, 15])
def test_st3d_frame_image_equals_jax(frame_pos):
    rng = np.random.default_rng(4)
    structs = []
    for cls in (SpaceTimeStruct, JaxST3D):
        struct = cls(list(range(16)), list(range(16)), H, W)
        gen = np.random.default_rng(4)
        for g in range(5):
            start = int(gen.integers(0, 8))
            ages = sorted({start, start + int(gen.integers(1, 5)),
                           start + int(gen.integers(5, 9))})
            x0, y0 = int(gen.integers(0, W - 10)), int(gen.integers(0, H - 10))
            w, h = int(gen.integers(2, 10)), int(gen.integers(2, 10))
            struct.group_ages[g] = ages
            struct.group_images[g] = [
                np.where(gen.random((h, w)) < 0.5, 255, 0).astype(np.uint8)
                for _ in range(len(ages) - 1)]
            struct.group_boundaries[g] = (x0, x0 + w - 1, y0, y0 + h - 1)
        structs.append(struct)
    del rng
    assert np.array_equal(visualizer.st3d_frame_image(structs[0], frame_pos),
                          jax_visualizer.st3d_frame_image(structs[1],
                                                          frame_pos))
    assert np.array_equal(
        visualizer.st3d_frame_image(structs[0], frame_pos, [1, 3]),
        jax_visualizer.st3d_frame_image(structs[1], frame_pos, [1, 3]))


def test_vis_gt_intervals_cli_equals_jax(workspace):
    """Its stdout, and the plot's decoded pixels (matplotlib's PNG carries
    its own metadata)."""
    root, conf, _, _ = workspace
    plot = os.path.join(root, "output", "images",
                        f"gt_intervals_{LECTURE}.png")
    texts, pixels = [], []
    for main in (jax_vis_cli.main, vis_cli.main):
        texts.append(_stdout(main, ["vis_gt_intervals", conf, "-l",
                                    LECTURE]))
        with open(plot, "rb") as f:
            pixels.append(decode_png_color(f.read()))
        os.remove(plot)
    assert texts[0] == texts[1]
    assert texts[1].endswith(f"Wrote {plot}\n")
    assert pixels[0].shape == (720, 960, 3)
    assert np.array_equal(pixels[0], pixels[1])


def test_signal_plot_without_intervals(tmp_path):
    signals = {"a": np.arange(10.0), "b": np.sin(np.arange(10.0))}
    pixels = []
    for module, name in ((jax_visualizer, "jax.png"),
                         (visualizer, "port.png")):
        path = module.signal_plot(signals, str(tmp_path / name))
        with open(path, "rb") as f:
            pixels.append(decode_png_color(f.read()))
    assert np.array_equal(pixels[0], pixels[1])


# ---------------------------------------------------------- dataset prep

def _polygons(rng, n, height, width):
    """Text polygons of 4-7 vertices, some reaching past the image."""
    return [{"points": np.stack([rng.integers(-10, width + 10, k),
                                 rng.integers(-10, height + 10, k)],
                                1).tolist()}
            for k in rng.integers(4, 8, n)]


@pytest.mark.parametrize("seed", range(3))
def test_rasterize_text_regions_equals_jax(seed):
    rng = np.random.default_rng(seed)
    entries = _polygons(rng, 6, 40, 60)
    assert np.array_equal(text_masks.rasterize_text_regions(entries, 40, 60),
                          jax_text_masks.rasterize_text_regions(entries,
                                                                40, 60))


def _jpeg(path, rng, h, w):
    assert cv2.imwrite(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_prepare_text_masks_cli_equals_jax(tmp_path):
    rng = np.random.default_rng(11)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    gt = {}
    for k, (h, w) in enumerate([(48, 64), (300, 270), (260, 40)]):
        _jpeg(str(img_dir / f"img_{k}.jpg"), rng, h, w)
        gt[f"img_{k}"] = _polygons(rng, 4, h, w)
    gt["missing"] = _polygons(rng, 1, 10, 10)
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(gt, f)
    results = []
    for main, out in ((jax_text_masks.main, "jax"), (text_masks.main, "port")):
        text = _stdout(main, ["prepare_text_masks", str(tmp_path / "gt.json"),
                              str(img_dir), str(tmp_path / out)])
        results.append((text, _tree(str(tmp_path / out))))
    assert results[0] == results[1]
    assert sorted(results[1][1]) == [f"img_{k}.png" for k in range(3)]
    assert "missing image: missing" in results[1][0]


def test_prepare_cocotext_cli_equals_jax(tmp_path):
    rng = np.random.default_rng(12)
    in_dir = tmp_path / "coco"
    in_dir.mkdir()
    gt = {"imgToAnns": {}, "imgs": {}, "anns": {}}
    ann = 0
    for k, split in enumerate(["train", "val", "test", "train", "Val",
                               "other", "train"]):
        img_id = str(100 + k)
        h, w = (int(v) for v in rng.integers(20, 80, 2))
        if k != 6:   # the last one is missing on disk
            _jpeg(str(in_dir / f"COCO_train2014_{img_id.zfill(12)}.jpg"),
                  rng, h, w)
        ids = []
        for _ in range(int(rng.integers(0, 4))):
            ann += 1
            ids.append(ann)
            gt["anns"][str(ann)] = {"polygon": rng.uniform(
                -5, max(h, w) + 5, 8).round(2).tolist()}
        gt["imgToAnns"][img_id] = ids
        gt["imgs"][img_id] = {"set": split}
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(gt, f)
    results = []
    for main, out in ((jax_cocotext.main, "jax"), (cocotext.main, "port")):
        dirs = [str(tmp_path / out / d) for d in
                ("ti", "tm", "vi", "vm", "si", "sm")]
        text = _stdout(main, ["prepare_cocotext", str(in_dir),
                              str(tmp_path / "gt.json"), *dirs])
        results.append((text.replace(out, "OUT"), _tree(str(tmp_path / out))))
    assert results[0] == results[1]
    masks = [p for p in results[1][1] if p.endswith(".png")]
    assert len(masks) == 5


def test_validate_dataset_cli_equals_jax(tmp_path):
    """Loadable, small and unloadable PNGs and JPEGs (a truncated PNG, a
    file of garbage under a .jpg name, a JPEG under a .png name)."""
    rng = np.random.default_rng(13)
    for name, (h, w) in (("big.jpg", (260, 300)), ("small.jpg", (40, 300)),
                         ("big.png", (256, 256)), ("small.png", (255, 400))):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if name.endswith(".png"):
            (tmp_path / name).write_bytes(encode_png(image))
        else:
            assert cv2.imwrite(str(tmp_path / name), image)
    full = encode_png(rng.integers(0, 256, (300, 300), dtype=np.uint8))
    (tmp_path / "cut.png").write_bytes(full[:len(full) // 2])
    (tmp_path / "junk.jpg").write_bytes(b"not an image at all")
    (tmp_path / "jpeg_named.png").write_bytes(
        (tmp_path / "big.jpg").read_bytes())
    (tmp_path / "notes.txt").write_text("skipped")
    for argv in (["v", str(tmp_path)], ["v", str(tmp_path), "100"]):
        ours = _stdout(validate.main, argv)
        assert ours == _stdout(jax_validate.main, argv)
    assert "UNLOADABLE: cut.png" in ours and "UNLOADABLE: junk.jpg" in ours
    assert "2 unloadable, 1 below 100px" in ours


@pytest.mark.parametrize("module", [
    (validate, jax_validate), (text_masks, jax_text_masks),
    (cocotext, jax_cocotext), (export_cli, jax_export_cli),
    (metrics_cli, jax_metrics_cli), (vis_cli, jax_vis_cli)],
    ids=lambda pair: pair[0].__name__.rsplit(".", 1)[-1])
def test_cli_usage_equals_jax(module):
    """Without arguments each CLI prints its usage (the same text) and
    returns."""
    ours, theirs = module
    assert _stdout(ours.main, ["prog"]) == _stdout(theirs.main, ["prog"])
