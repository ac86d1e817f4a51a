"""Synthetic ground-truth trees for the evaluation tests of the port: the
AccessMath annotation layout (segments.xml with polygon video objects,
keyframes/, binary/, portions.xml + portions/, unique_ccs.xml), a generated
summary, the LectureAnnotation XML and the stage artifacts eval_segments
reads. Every PNG is written by the port's ``encode_png`` (the bytes
``cv2.imwrite`` writes). It imports only the port (its copies of the
synthetic lecture, the annotation model and the CC-group tooling), so the
card tests and the tests without OpenCV build their trees with it too."""

import os

import numpy as np

from lecturemath_tpu_torch.core.artifacts import ArtifactStore
from lecturemath_tpu_torch.eval.aligner import build_unique_cc_groups
from lecturemath_tpu_torch.eval.annotation import (KeyframeAnnotation,
                                                   UniqueCCGroup)
from lecturemath_tpu_torch.eval.lecture_annotation import LectureAnnotation
from lecturemath_tpu_torch.pipeline.keyframes import export_summary
from lecturemath_tpu_torch.utils.png import encode_png
from lecturemath_tpu_torch.utils.synthetic import (synthetic_lecture,
                                                   synthetic_rgb_lecture)

DB = "EVDB"

DB_XML = """<AccessMath><DataBase><Name>{db}</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Training>{training}</Training><Testing>{testing}</Testing></Datasets>
<Lectures>{lectures}</Lectures></DataBase></AccessMath>
"""

LECTURE_XML = """<Lecture><Id>{name}</Id><Title>{name}</Title><Parameters>
</Parameters><Videos><Main><Video><Path>{name}.mp4</Path></Video></Main>
</Videos></Lecture>"""

# video objects of every GT keyframe: a non-convex polygon reaching past the
# frame's left edge, with fractional vertices (truncated to int32 as the
# reference does), and an axis-aligned box in the X/Y/W/H form
SPEAKER = [[-6.5, 10.2], [20.7, 4.0], [14.0, 20.0], [28.3, 40.9],
           [2.0, 30.5]]
BOARD = (40.0, 6.0, 30.5, 22.25)

# the binarizer's TINY widths
TINY_KEYS = {
    **{f"FCN_BINARIZER_NET_DOWN_CONV_FILTERS_{i}": w
       for i, w in enumerate((2, 3, 4, 5, 6), 1)},
    "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 6,
    **{f"FCN_BINARIZER_NET_{kind}_FILTERS_{i}": w
       for kind in ("UPSAMPLE", "UP_CONV")
       for i, w in enumerate((2, 3, 4, 5, 6), 1)},
    "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 4,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 3,
    "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 3,
    "FCN_BINARIZER_NET_KERNEL_SIZE": 3,
}

STAGE_KEYS = {"BINARIZATION_OUTPUT": "tempo_binary_",
              "VIDEO_SEGMENTATION_OUTPUT": "tempo_intervals_"}


def write_png(path, image):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _objects_xml(objects):
    lines = ["       <VideoObjects>"]
    for name, shape in objects:
        lines.append(f"        <VideoObject><Name>{name}</Name>")
        if isinstance(shape, tuple):
            x, y, w, h = shape
            lines.append(f"         <X>{x}</X><Y>{y}</Y><W>{w}</W><H>{h}</H>")
        else:
            points = "".join(f"<Point><X>{x}</X><Y>{y}</Y></Point>"
                             for x, y in shape)
            lines.append(f"         <Shape>2</Shape><Polygon>{points}"
                         f"</Polygon>")
        lines.append("        </VideoObject>")
    lines.append("       </VideoObjects>")
    return lines


def segments_xml(lecture, segments, keyframes):
    """keyframes: (index, time, objects) with objects [(name, shape)]."""
    lines = ["<Annotations>", f"  <Database>{DB}</Database>",
             f"  <Lecture>{lecture}</Lecture>", "  <Filename>x</Filename>",
             f"  <VideoFiles><VideoFile>{lecture}.mp4</VideoFile>"
             f"</VideoFiles>", "  <VideoSegments>"]
    for start, end in segments:
        lines += ["    <VideoSegment>", f"      <Start>{start}</Start>",
                  f"      <End>{end}</End>", "    </VideoSegment>"]
    lines += ["  </VideoSegments>", "  <VideoKeyFrames>"]
    for idx, time, objects in keyframes:
        lines += ["    <VideoKeyFrame>", f"       <Index>{idx}</Index>",
                  f"       <AbsTime>{time}</AbsTime>"]
        lines += _objects_xml(objects)
        lines.append("    </VideoKeyFrame>")
    lines += ["  </VideoKeyFrames>", "</Annotations>"]
    return "\n".join(lines) + "\n"


def write_gt_lecture(root, lecture, segments, keyframes, groups=True):
    """keyframes: (index, time, raw RGB [H, W, 3], GT ink mask [H, W]
    bool, objects). Writes the GT tree of one lecture with one full-frame
    portion a keyframe and, with ``groups``, chained unique-CC groups over
    the keyframes combined per segment (keyframes of one size)."""
    prefix = os.path.join(root, "output", "annotations",
                          f"{DB}_{lecture.lower()}")
    portions = ["<Annotations>", "    <KeyFrames>"]
    for idx, _, raw, ink, _ in keyframes:
        binary = np.where(ink, 0, 255).astype(np.uint8)
        write_png(os.path.join(prefix, "keyframes", f"{idx}.png"),
                  raw[:, :, ::-1])
        write_png(os.path.join(prefix, "binary", f"{idx}.png"),
                  np.stack([binary] * 3, axis=-1))
        write_png(os.path.join(prefix, "portions", f"frame_{idx}", "0.png"),
                  np.stack([binary] * 3, axis=-1))
        h, w = ink.shape
        portions += ["        <KeyFrame>", f"            <Index>{idx}</Index>",
                     "            <Portions>", "                <KeyFramePortion>",
                     f"                    <X>0</X><Y>0</Y><W>{w}</W><H>{h}</H>",
                     "                    <Dark>0</Dark>",
                     "                </KeyFramePortion>",
                     "            </Portions>", "        </KeyFrame>"]
    portions += ["    </KeyFrames>", "</Annotations>"]
    with open(os.path.join(prefix, "portions.xml"), "w") as f:
        f.write("\n".join(portions) + "\n")
    xml_path = os.path.join(prefix, "segments.xml")
    with open(xml_path, "w") as f:
        f.write(segments_xml(lecture, segments,
                             [(idx, time, objects)
                              for idx, time, _, _, objects in keyframes]))
    if not groups:
        return prefix

    # the annotation tooling chains the groups over the combined GT
    gt_kfs, gt_segments = KeyframeAnnotation.load_exported_keyframes(
        xml_path, os.path.join(prefix, "keyframes") + "/", True)
    by_idx = {idx: ink for idx, _, _, ink, _ in keyframes}
    for kf in gt_kfs:
        binary = np.where(by_idx[kf.idx], 0, 255).astype(np.uint8)
        kf.binary_image = np.stack([binary] * 3, axis=-1)
        kf.update_binary_cc(False)
    combined = KeyframeAnnotation.combine_per_segment(gt_kfs, gt_segments,
                                                      False)
    groups, _ = build_unique_cc_groups(combined, local_window=3,
                                       min_recall=0.8, min_precision=0.8)
    with open(os.path.join(prefix, "unique_ccs.xml"), "w") as f:
        f.write(UniqueCCGroup.groups_to_xml(combined, groups))
    return prefix


def write_summary(root, lecture, segments, keyframes):
    """keyframes: (index, time, ink mask) exported as a generated summary."""
    times = [(1000.0 * s, 1000.0 * e) for s, e in segments]
    export_summary(os.path.join(root, "output", "summaries",
                                f"{DB}_{lecture.lower()}"),
                   DB, lecture, [f"{lecture}.mp4"], segments, times,
                   [idx for idx, _, _ in keyframes],
                   [time for _, time, _ in keyframes],
                   [np.stack([np.where(ink, 0, 255).astype(np.uint8)] * 3,
                             axis=-1) for _, _, ink in keyframes])


def write_workspace(root, training=(), testing=(), extra=""):
    """db.xml and eval.conf for the lectures named (each once)."""
    lectures = list(training) + [t for t in testing if t not in training]
    with open(os.path.join(root, "db.xml"), "w") as f:
        f.write(DB_XML.format(
            db=DB,
            training="".join(f"<LectureTitle>{t}</LectureTitle>"
                             for t in training),
            testing="".join(f"<LectureTitle>{t}</LectureTitle>"
                            for t in testing),
            lectures="".join(LECTURE_XML.format(name=t) for t in lectures)))
    conf = os.path.join(root, "eval.conf")
    with open(conf, "w") as f:
        f.write(f"VIDEO_DATABASE_PATH = {root}/db.xml\n"
                f"OUTPUT_PATH = {root}/output\n"
                + "".join(f"{k} = {v}\n" for k, v in STAGE_KEYS.items())
                + extra)
    return conf


def summary_tree(root):
    """Lecture ev01 (64x96, 4 GT keyframes over 3 segments, two of them in
    the first, with polygon objects) and a generated summary of it whose
    keyframes drop 3% of the ink and split the lecture differently; plus
    the LectureAnnotation XML and the stage artifacts of a predicted
    segmentation. Returns the config path."""
    frames, _, _ = synthetic_lecture(seed=9, n_frames=24, height=64,
                                     width=96, n_boards=2, glyphs_per_board=4,
                                     glyph_size=(12, 14))
    objects = [("speaker", SPEAKER), ("board", BOARD)]
    picks = [(150, 5000.0, 4), (210, 7000.0, 6), (330, 11000.0, 11),
             (690, 23000.0, 23)]
    keyframes = []
    for idx, time, k in picks:
        ink = frames[k] > 0
        raw = np.where(ink[..., None], 30, 215).astype(np.uint8)
        raw = np.repeat(raw, 3, axis=2)
        raw[..., 2] = 200  # colour, so the red/blue order matters
        keyframes.append((idx, time, raw, ink,
                          objects if k != 6 else objects[:1]))
    gt_segments = [(0, 240), (240, 480), (480, 720)]
    write_gt_lecture(root, "ev01", gt_segments, keyframes)

    rng = np.random.default_rng(0)
    summary = []
    for idx, time, k in [(120, 4000.0, 4), (330, 11000.0, 11),
                         (520, 17000.0, 17), (690, 23000.0, 23)]:
        ink = (frames[k] > 0) & ~(rng.random((64, 96)) < 0.03)
        # spurious specks, some on the objects (background) and some not
        for y, x in rng.integers(0, (62, 94), (6, 2)):
            ink[y:y + 2, x:x + 2] = True
        summary.append((idx, time, ink))
    write_summary(root, "ev01", [(0, 200), (200, 480), (480, 600),
                                 (600, 720)], summary)

    annotation = LectureAnnotation(DB, "ev01", "ev01.xml", ["ev01.mp4"],
                                   total_frames=720)
    annotation.video_segments = [240, 480]
    annotation.video_segment_keyframes = [150, 330, 690]
    annotation.save(os.path.join(root, "output", "annotations",
                                 f"{DB}_ev01.xml"))
    store = ArtifactStore(os.path.join(root, "output", "temporal"))
    indices = list(range(0, 720, 30))
    store.save((np.arange(24) * 1000.0, indices, None),
               STAGE_KEYS["BINARIZATION_OUTPUT"], "ev01")
    store.save([(0, 7), (8, 15), (16, 23)],
               STAGE_KEYS["VIDEO_SEGMENTATION_OUTPUT"], "ev01")
    return write_workspace(root, training=["ev01"], testing=["ev01"])


def self_summary_tree(root):
    """The GT of ``summary_tree`` combined per segment (the first
    segment's two keyframes merged, as the evaluator merges them), exported
    as a summary under the baseline prefix ``self_``."""
    frames, _, _ = synthetic_lecture(seed=9, n_frames=24, height=64,
                                     width=96, n_boards=2, glyphs_per_board=4,
                                     glyph_size=(12, 14))
    keyframes = [(210, 7000.0, (frames[4] > 0) | (frames[6] > 0)),
                 (330, 11000.0, frames[11] > 0),
                 (690, 23000.0, frames[23] > 0)]
    export_summary(os.path.join(root, "output", "summaries",
                                f"self_{DB}_ev01"),
                   DB, "ev01", ["ev01.mp4"], [(0, 240), (240, 480),
                                              (480, 720)],
                   [(0.0, 8000.0), (8000.0, 16000.0), (16000.0, 24000.0)],
                   [k[0] for k in keyframes], [k[1] for k in keyframes],
                   [np.stack([np.where(ink, 0, 255).astype(np.uint8)] * 3,
                             axis=-1) for _, _, ink in keyframes])


def keyframe_bin_tree(root, widths=TINY_KEYS):
    """Lecture kb01 for the binarizer-quality protocol: 3 RGB keyframes at
    64x96 and 2 at 48x80 (two resolution buckets), GT binaries from the
    synthetic lecture's ink, polygon objects; the config sets ``widths``
    (config key -> value). Returns the config path."""
    keyframes = []
    for k, (seed, h, w) in enumerate([(4, 64, 96)] * 3 + [(5, 48, 80)] * 2):
        rgb, binary, _, _ = synthetic_rgb_lecture(
            seed=seed, n_frames=3, height=h, width=w, glyphs_per_board=3,
            glyph_size=(12, 14))
        keyframes.append((100 * (k + 1), 3300.0 * (k + 1), rgb[k % 3],
                          binary[k % 3] > 0,
                          [("speaker", SPEAKER), ("board", BOARD)]))
    write_gt_lecture(root, "kb01", [(0, 150), (150, 250), (250, 350),
                                    (350, 450), (450, 600)], keyframes,
                     groups=False)
    return write_workspace(root, training=["kb01"], testing=[],
                           extra="FCN_BINARIZER_SAVE_BINARY = 0\n" + "".join(
                               f"{key} = {value}\n"
                               for key, value in widths.items()))
