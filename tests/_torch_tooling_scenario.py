"""One run of the ground-truth tooling, for either package: a GT tree
authored from seeded keyframes (eval/gt_authoring), a full-video
LectureAnnotation with a speaker and text regions, the word/formula tier
over the tree (eval/words: default and edited projections, warps, word
trees, projections / word / unique-word / formula XML, and loading them
back), the text-region export in its two PNG modes (eval/text_export) and
the dataset-prep mask writers. ``run(package, root)`` writes everything
under ``root`` and returns a JSON-able summary.

Images are read with the port's ``read_image`` for either package (it is
only the input), so a run of the port needs no OpenCV. The parity tests
run it for both packages into the same path (files that name their own
path stay equal); the tests without OpenCV run it for the port in a child
with cv2, PIL and matplotlib blocked."""

import importlib
import os

import numpy as np

from lecturemath_tpu_torch.utils.png import read_image, write_image

DB = "GTDB"
LECTURE = "Lec01"
HEIGHT, WIDTH = 72, 120
KEYFRAMES = (10, 25, 40)
TOTAL_FRAMES = 48
# the annotator's edit of the second keyframe's projection: one corner
CORNER, DELTA = 2, (-6.5, 4.25)
# text regions (id, polygon on the annotation canvas at frames 0 and 47)
TEXT_OBJECTS = (
    ("text_a", [(8, 6), (50, 6), (50, 20), (8, 20)],
     [(12, 8), (56, 8), (56, 24), (12, 24)]),
    ("Text_b", [(60, 30), (110, 28), (112, 44), (58, 46)],
     [(60, 30), (110, 28), (112, 44), (58, 46)]),
    ("text_c", [(-5, 50), (30, 50), (30, 80), (-5, 80)],
     [(20, 50), (70, 52), (68, 70), (22, 69)]),
    ("board", [(0, 0), (119, 0), (119, 71), (0, 71)],
     [(0, 0), (119, 0), (119, 71), (0, 71)]),
)
SPEAKER = {0: (70.0, 20.0, 30.0, 50.0), 30: (20.0, 10.0, 35.0, 60.0),
           47: (5.0, 40.0, 30.0, 30.0)}
# the GUI viewport: canvas and player render box (annotation coordinates
# are scaled from the render box to the frame)
RENDER_BOX = (2.0, 3.0, 100.0, 60.0)


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


def keyframes(seed=0):
    """(binary ink=0 [H, W], raw RGB [H, W, 3]) of each keyframe: rows of
    glyph blocks grouped in words, more of them in each later keyframe."""
    rng = np.random.default_rng(seed)
    out = []
    words = []
    for k, _ in enumerate(KEYFRAMES):
        for _ in range(3):
            row = int(rng.integers(0, 4))
            words.append((4 + 17 * row, 6 + int(rng.integers(0, 84))))
        binary = np.full((HEIGHT, WIDTH), 255, np.uint8)
        for y, x in words:
            for g in range(int(rng.integers(2, 5))):
                gx = x + 6 * g
                binary[y:y + int(rng.integers(5, 11)),
                       gx:gx + int(rng.integers(2, 5))] = 0
        raw = np.stack([np.full((HEIGHT, WIDTH), 40 + 30 * k, np.uint8),
                        np.full((HEIGHT, WIDTH), 120, np.uint8),
                        np.full((HEIGHT, WIDTH), 200, np.uint8)], axis=-1)
        raw[binary == 0] = (250, 250, 240)
        out.append((binary, raw))
    return out


def _loaded_keyframes(package, prefix):
    annotation = _module(package, "eval.annotation")
    frames = annotation.KeyframeAnnotation.load_exported_keyframes(
        os.path.join(prefix, "segments.xml"),
        os.path.join(prefix, "keyframes") + "/", False)
    for kf in frames:
        kf.raw_image = read_image(os.path.join(prefix, "keyframes",
                                               f"{kf.idx}.png"))
        kf.binary_image = read_image(os.path.join(prefix, "binary",
                                                  f"{kf.idx}.png"))
        kf.update_binary_cc(False)
    return frames


def lecture_annotation(package):
    """The full-video annotation: splits, keyframes, a speaker track and
    the text regions (one of them outside the text prefixes)."""
    gt = _module(package, "eval.gt_authoring")
    la = _module(package, "eval.lecture_annotation")
    annotation = gt.author_lecture_annotation(
        DB, LECTURE, [f"{LECTURE}.mp4"], TOTAL_FRAMES, [30, 12],
        list(KEYFRAMES), "lecture.xml")
    gt.add_segment_split(annotation, 20)
    gt.add_segment_split(annotation, 12)
    gt.remove_segment_split(annotation, 20)
    gt.set_speaker_track(annotation, SPEAKER)
    for object_id, first, last in TEXT_OBJECTS:
        obj = la.TimelineObject(object_id, object_id,
                                la.TimelineObject.SHAPE_POLYGON)
        obj.set_location_at(0, 0.0, True, first)
        obj.set_location_at(TOTAL_FRAMES - 1, 1566.0, True, last)
        if object_id == "Text_b":
            obj.set_location_at(20, 660.0, False, first)
        annotation.video_objects[object_id] = obj
    annotation.drawing_info = la.DrawingInfo(
        (0.0, 0.0, 104.0, 66.0), (0.0, 64.0, 104.0, 2.0), RENDER_BOX)
    return annotation


def _word_tier(package, root, frames):
    words = _module(package, "eval.words")
    region_tree = _module(package, "data.region_tree")
    annotation = _module(package, "eval.annotation")
    all_words = []
    for k, kf in enumerate(frames):
        kf_words = words.KeyFrameWords.create_default(kf)
        if k == 1:
            projection = kf_words.projection.copy()
            moved = projection.src_points.copy()
            moved[CORNER] += DELTA
            projection.update_from_points(projection.src_points, moved)
            kf_words = words.KeyFrameWords(
                kf, projection, region_tree.RegionTree.from_binary(
                    words.warped_inverted_binary(kf, projection)))
            mask = np.zeros((HEIGHT, WIDTH), bool)
            mask[10:40, 20:90] = True
            raw, binary, warped_mask = projection.warp_keyframe(
                kf.raw_image, kf.binary_image, mask)
            os.makedirs(os.path.join(root, "warps"), exist_ok=True)
            for name, image in (("raw", raw), ("binary", binary),
                                ("mask", warped_mask.astype(np.uint8) * 255)):
                write_image(os.path.join(root, "warps", f"{name}.png"), image)
        kf_words.tree.segment_recursive()
        all_words.append(kf_words)

    words.save_projections(os.path.join(root, "projections.xml"),
                           [w.projection for w in all_words])
    words.save_word_annotations(os.path.join(root, "word_annotations.xml"),
                                all_words)
    words.save_word_annotations(os.path.join(root, "word_trees.xml"),
                                all_words, trees_only=True)
    _, groups = words.default_word_groups(all_words)
    first, second = all_words[0].get_words(), all_words[1].get_words()
    chain = words.UniqueWordGroup(first[0], 0)
    chain.words_refs.append(second[0])
    groups = [chain] + [g for g in groups
                        if g.str_id() not in (f"0-{words.word_id(first[0])}",
                                              f"1-{words.word_id(second[0])}")]
    tail = words.UniqueWordGroup.split(words.UniqueWordGroup.copy(chain), 1)
    words.save_unique_words(os.path.join(root, "unique_words.xml"),
                            all_words, groups)

    projections = words.load_projections(os.path.join(root,
                                                      "projections.xml"))
    loaded = words.load_word_annotations(
        os.path.join(root, "word_annotations.xml"), frames)
    from_trees = words.load_word_annotations(
        os.path.join(root, "word_trees.xml"), frames, projections)
    _, loaded_groups = words.load_unique_words(
        os.path.join(root, "unique_words.xml"), loaded)

    cc_group, cc_groups = annotation.UniqueCCGroup.groups_from_xml(
        frames, os.path.join(root, "annotations", f"{DB}_{LECTURE.lower()}",
                             "unique_ccs.xml"))
    formulas = [words.FormulaCCs(cc_groups[:3], "x^2"),
                words.FormulaCCs(cc_groups[3:5], r"\frac{a}{b}"),
                words.FormulaCCs(cc_groups[-2:], "")]
    formulas[0].add_group(cc_groups[6])
    formulas[0].remove_group(cc_groups[0])
    words.save_formulas(os.path.join(root, "formulas.xml"), formulas)
    loaded_formulas = words.load_formulas(
        os.path.join(root, "formulas.xml"), cc_groups[1:])
    points = np.array([[0.0, 0.0], [60.5, 33.25], [119.0, 71.0]])
    return {
        "words": [[list(b) for b in w.get_words()] for w in all_words],
        "loaded": [[list(b) for b in w.get_words()] for w in loaded],
        "from_trees": [[list(b) for b in w.get_words()]
                       for w in from_trees],
        "in_region": [list(b) for b in all_words[2].words_in_region(
            0, 70, 0, 40)],
        "groups": [g.str_id() for g in loaded_groups],
        "split": [chain.str_id(), tail and tail.str_id()],
        "formulas": [[f.str_id(), f.latex_tag, f.first_visible,
                      f.last_visible] for f in loaded_formulas],
        "warp_points": projections[1].warp_points(points).tolist(),
        "unwarp_points": projections[1].warp_points(
            points, inverse=True).tolist(),
        "cc_groups": len(cc_group),
    }


def _text_export(package, root, frames):
    text_export = _module(package, "eval.text_export")
    annotation = lecture_annotation(package)
    annotation.save(os.path.join(root, "lecture.xml"))
    out = {}
    for mode, name in ((text_export.TextAnnotationExporter.ALL_PER_FRAME,
                        "per_frame"),
                       (text_export.TextAnnotationExporter.UNIQUE_BOXES,
                        "unique")):
        exporter = text_export.TextAnnotationExporter(
            annotation, ["text"], "Speaker", 0.25, mode,
            os.path.join(root, "text", name), export_images=True)
        exporter.initialize(WIDTH, HEIGHT)
        states = []
        for frame_idx in range(0, TOTAL_FRAMES, 5):
            binary, raw = frames[frame_idx % len(frames)]
            bgr = np.ascontiguousarray(raw[:, :, ::-1])
            if mode == exporter.ALL_PER_FRAME:
                _, visible, _ = exporter.frame_visible_bboxes_state(
                    frame_idx)
                exporter.export_all_by_frame(bgr, frame_idx, visible, binary)
            else:
                exporter.handle_frame(bgr, frame_idx)
            _, visible, occluded = exporter.frame_visible_bboxes_state(
                frame_idx)
            states.append([[n, np.asarray(p).tolist()] for n, p in visible]
                          + [len(occluded)])
        exporter.finalize()
        out[name] = states
    return out


def _masks(package, root):
    text_masks = _module(package, "cli.prepare_text_masks")
    cocotext = _module(package, "cli.prepare_cocotext")
    rng = np.random.default_rng(3)
    entries = [{"points": np.stack([rng.integers(-8, WIDTH + 8, k),
                                    rng.integers(-8, HEIGHT + 8, k)],
                                   1).tolist()}
               for k in rng.integers(3, 8, 6)]
    table = {str(k): {"polygon": rng.uniform(-4, WIDTH + 4, 10).round(2)
                      .tolist()} for k in range(5)}
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    write_image(os.path.join(root, "masks", "lsvt.png"),
                text_masks.rasterize_text_regions(entries, HEIGHT, WIDTH))
    write_image(os.path.join(root, "masks", "coco.png"),
                cocotext.coco_polygon_mask(range(5), table, HEIGHT, WIDTH))


def run(package, root):
    """Every step above under ``root``; returns the summary."""
    gt = _module(package, "eval.gt_authoring")
    frames = keyframes()
    prefix = gt.export_gt_tree(
        os.path.join(root, "annotations"), DB, LECTURE, list(KEYFRAMES),
        [k * 1000.0 / 30 for k in KEYFRAMES], [b for b, _ in frames],
        [r for _, r in frames], video_paths=[f"{LECTURE}.mp4"],
        write_portions=True)
    gt.export_gt_tree(os.path.join(root, "binary_only"), DB, LECTURE,
                      list(KEYFRAMES), [1.0, 2.0, 3.0],
                      [b for b, _ in frames],
                      segments=[(0, 17), (18, 30), (31, TOTAL_FRAMES - 1)])
    summary = {"prefix": os.path.relpath(prefix, root)}
    summary.update(_word_tier(package, root, _loaded_keyframes(package,
                                                               prefix)))
    summary["text"] = _text_export(package, root, frames)
    _masks(package, root)
    return summary
