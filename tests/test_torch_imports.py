"""The port (lecturemath_tpu_torch and chip_smoke.py) imports nothing of JAX
and nothing of the JAX package: not at module level, not lazily inside a
function."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "lecturemath_tpu_torch"
BANNED = ("jax", "flax", "optax", "orbax", "lecturemath_tpu")


def _banned(module: str) -> bool:
    """Exact name or dotted prefix: 'lecturemath_tpu_torch' is allowed."""
    return any(module == name or module.startswith(name + ".")
               for name in BANNED)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "flagship_drive_torch.py")]
    for directory in (PACKAGE, "scripts_torch"):
        for root, _, names in os.walk(os.path.join(REPO, directory)):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    return sorted(files)


def _is_wrapper(path: str) -> bool:
    """A run-book wrapper of scripts_torch/: a script, not a module."""
    return os.path.basename(os.path.dirname(path)) == "scripts_torch"


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel)


def _imports(path: str):
    """Absolute module names of every import statement in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    package = _module_name(path)
    if not path.endswith("__init__.py"):
        package = package.rpartition(".")[0]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module
            else:
                parts = package.split(".")
                assert node.level - 1 < len(parts), (path, node.lineno)
                base = ".".join(parts[:len(parts) - (node.level - 1)])
                if node.module:
                    base = f"{base}.{node.module}"
            yield base
            for alias in node.names:
                yield f"{base}.{alias.name}"


def test_banned_prefix_rule():
    assert _banned("jax.numpy") and _banned("lecturemath_tpu.ops")
    assert _banned("lecturemath_tpu") and _banned("flax")
    assert not _banned("lecturemath_tpu_torch.ops")
    assert not _banned("jaxtyping_like") and not _banned("torch")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_banned_import_statement(path):
    found = [name for name in _imports(path) if _banned(name)]
    assert not found, f"{os.path.relpath(path, REPO)} imports {found}"


_BLOCKED_IMPORT = r"""
import importlib, importlib.util, os, sys
BANNED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BANNED):
            raise ImportError("blocked import of " + name)
        return None

for name in list(sys.modules):
    if any(name == b or name.startswith(b + ".") for b in BANNED):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
for module in %r:
    importlib.import_module(module)
for path in %r:
    spec = importlib.util.spec_from_file_location("wrapper", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len(%r))
"""


def test_every_port_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()
               if not p.endswith("chip_smoke.py") and not _is_wrapper(p)]
    wrappers = [p for p in _port_files() if _is_wrapper(p)]
    assert len(wrappers) == 18
    script = _BLOCKED_IMPORT % (BANNED, REPO, modules, wrappers,
                                modules + wrappers)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            capture_output=True, text=True, timeout=120,
                            env=env)
    assert result.returncode == 0, result.stderr[-3000:]
    assert f"imported {len(modules) + len(wrappers)}" in result.stdout


SLICE_MODULES = [
    "lecturemath_tpu_torch.utils.png",
    "lecturemath_tpu_torch.ops.cc_label",
    "lecturemath_tpu_torch.ops.cc_label_pallas",
    "lecturemath_tpu_torch.pipeline.stages",
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "binarize", "cc_analysis", "cc_grouping", "vid_segmentation",
        "generate_summary", "quickstart")],
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_staged_slice_modules_are_checked(module):
    """The staged CLIs, stages.py, the CC labeling ops and the PNG codec are
    among the files the checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


SERVING_MODULES = [
    "lecturemath_tpu_torch.core.backend_probe",
    "lecturemath_tpu_torch.utils.image",
    "lecturemath_tpu_torch.pipeline.server",
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "serve", "binarize_image", "doctor")],
]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_slice_modules_are_checked(module):
    """The serving surface, its companion CLIs, the probe and the image
    operations are among the files the checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


TRAINING_MODULES = [
    "lecturemath_tpu_torch.parallel.mesh",
    *[f"lecturemath_tpu_torch.train.{name}" for name in (
        "augment", "dataset", "losses", "prefetch", "trainer")],
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "train_reconstruction", "train_text_detector", "train_binarizer")],
]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_slice_modules_are_checked(module):
    """The training curriculum, its data path, the mesh requests and the
    three training CLIs are among the files the checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


SCALE_OUT_MODULES = [
    *[f"lecturemath_tpu_torch.parallel.{name}" for name in (
        "inference", "sync_norm", "launch")],
    "lecturemath_tpu_torch.parallel",
    "lecturemath_tpu_torch.cli.run_pipeline",
]


@pytest.mark.parametrize("module", SCALE_OUT_MODULES)
def test_scale_out_modules_are_checked(module):
    """Frame-sharded inference, the cross-replica BatchNorm, the training
    CLIs' local launch and express's mesh request are among the files the
    checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


WORKER_AND_OPS_MODULES = [
    "lecturemath_tpu_torch.pipeline.device_worker",
    *[f"lecturemath_tpu_torch.ops.{name}" for name in (
        "clahe", "frame_diff", "ckmeans", "classical", "interval_index")],
    "lecturemath_tpu_torch.models.caffe_loader",
    *[f"lecturemath_tpu_torch.data.{name}" for name in (
        "content_region", "region_tree")],
]


@pytest.mark.parametrize("module", WORKER_AND_OPS_MODULES)
def test_worker_and_ops_modules_are_checked(module):
    """The recycled device worker, the device and classical ops, the caffe
    reader and the region data are among the files the checks above
    walk."""
    assert module in [_module_name(p) for p in _port_files()]


TOOLING_MODULES = [
    "lecturemath_tpu_torch.utils.geometry",
    "lecturemath_tpu_torch.utils.visualizer",
    *[f"lecturemath_tpu_torch.pipeline.{name}" for name in (
        "video_metrics", "export_video")],
    *[f"lecturemath_tpu_torch.eval.{name}" for name in (
        "gt_authoring", "text_export", "visual_alignment", "words")],
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "video_metrics", "export_video", "vis_gt_intervals",
        "prepare_text_masks", "prepare_cocotext", "validate_dataset")],
]


@pytest.mark.parametrize("module", TOOLING_MODULES)
def test_tooling_modules_are_checked(module):
    """The video export and metrics, the visualizer, the ground-truth
    tooling and the dataset-prep CLIs are among the files the checks above
    walk."""
    assert module in [_module_name(p) for p in _port_files()]


EDITOR_MODULES = [
    *[f"lecturemath_tpu_torch.utils.{name}" for name in (
        "gt_editor", "word_editor", "annotation_editor", "st3d_visualizer")],
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "gt_editor", "word_annotator", "annotation_editor",
        "st3d_visualizer")],
]


@pytest.mark.parametrize("module", EDITOR_MODULES)
def test_editor_modules_are_checked(module):
    """The four browser editors and their CLIs are among the files the
    checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


# the functions of the editors' path that may still import OpenCV: the
# bilateral smoothing (sigma_color > 0), the video capture, and the labels'
# Hershey font
EDITOR_CV2_FUNCTIONS = {
    "utils/gt_editor.py": {"gray"},
    "utils/annotation_editor.py": {"_probe_videos", "_file_counts",
                                   "_decode_count", "_video_frame"},
    "utils/word_editor.py": set(),
    "utils/st3d_visualizer.py": set(),
    "utils/visualizer.py": {"put_label", "signal_plot"},
}


@pytest.mark.parametrize("rel", sorted(EDITOR_CV2_FUNCTIONS))
def test_editors_import_opencv_only_where_named(rel):
    """cv2, PIL and matplotlib are imported by the editors' modules only
    inside the functions that still need them, never at module level or
    in a server or handler."""
    path = os.path.join(REPO, PACKAGE, rel)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = set()

    def walk(node, function):
        for child in ast.iter_child_nodes(node):
            name = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else function)
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                modules = ([a.name for a in child.names]
                           if isinstance(child, ast.Import)
                           else [child.module or ""])
                if any(m.split(".")[0] in ("cv2", "PIL", "matplotlib")
                       for m in modules):
                    found.add(function)
            walk(child, name)

    walk(tree, None)
    assert found <= EDITOR_CV2_FUNCTIONS[rel], found


def test_the_port_has_every_jax_module_but_the_pallas_kernels():
    """Every .py file of the JAX package has its counterpart in the port,
    except the two Pallas kernel files (ported as ops/conv7.py and
    ops/postprocess.py around their CUDA kernels)."""
    def files(package):
        root = os.path.join(REPO, package)
        return {os.path.relpath(os.path.join(base, name), root)
                for base, _, names in os.walk(root) for name in names
                if name.endswith(".py")}

    missing = files("lecturemath_tpu") - files(PACKAGE)
    assert missing == {os.path.join("ops", "pallas_conv7.py"),
                       os.path.join("ops", "pallas_postprocess.py")}


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_command_names_a_jax_module(path):
    """No string of the port tells its user to run a module of the JAX
    package (``python -m lecturemath_tpu.<...>``), which the card's machine
    cannot run."""
    import re

    with open(path) as f:
        text = f.read()
    assert not re.findall(r"python3? -m lecturemath_tpu\.", text)


def test_quickstart_next_steps_name_the_port():
    """The "Next steps" the quickstart prints name only the port's
    modules, the GT editor and eval_summaries among them, and each of them
    exists."""
    import importlib.util
    import re

    from lecturemath_tpu_torch.cli.quickstart import next_steps

    lines = next_steps("demo.conf")
    modules = [m for line in lines
               for m in re.findall(r"python3? -m ([\w.]+)", line)]
    assert modules == ["lecturemath_tpu_torch.cli.binarize",
                       "lecturemath_tpu_torch.cli.gt_editor",
                       "lecturemath_tpu_torch.cli.eval_summaries"]
    assert all(importlib.util.find_spec(m) is not None for m in modules)
    assert all("demo.conf" in line for line in lines[:3])


def test_ops_package_exports_the_jax_names():
    """``lecturemath_tpu_torch.ops`` exports every name the JAX package's
    ``ops/__init__.py`` imports (read from its source, not imported)."""
    import importlib

    with open(os.path.join(REPO, "lecturemath_tpu", "ops",
                           "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = [alias.asname or alias.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for alias in node.names]
    ops = importlib.import_module(f"{PACKAGE}.ops")
    assert len(names) >= 14
    assert [name for name in names if not hasattr(ops, name)] == []


_NO_OPENCV = r"""
import os, sys
BANNED = ("cv2", "PIL")

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BANNED):
            raise ImportError("blocked import of " + name)
        return None

for name in list(sys.modules):
    if any(name == b or name.startswith(b + ".") for b in BANNED):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import numpy as np
from lecturemath_tpu_torch.pipeline.keyframes import export_summary
from lecturemath_tpu_torch.pipeline.video import compress_png, decompress_png
frames = [np.where(np.random.default_rng(k).random((20, 30)) < 0.2, 255,
                   0).astype(np.uint8) for k in range(3)]
buffers = compress_png(frames)
assert all(b.dtype == np.uint8 and b.shape[1] == 1 for b in buffers)
for frame, back in zip(frames, decompress_png(buffers)):
    assert (frame == back).all()
keyframe = np.repeat(frames[0][..., None], 3, axis=2)
export_summary(%r, "DB", "lecture", ["v"], [(0, 2)], [(0.0, 2.0)], [2],
               [2.0], [keyframe])
print("relay ok")
"""


def test_png_relay_and_export_need_no_opencv(tmp_path):
    """The stage-artifact PNG relay and the keyframe export run with cv2
    and PIL unimportable, as on a machine that has neither."""
    script = _NO_OPENCV % (REPO, str(tmp_path / "summary"))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "relay ok" in result.stdout
    assert (tmp_path / "summary" / "keyframes" / "2.png").exists()


_SERVING_NO_OPENCV = r"""
import sys
for name in ("cv2", "PIL", "PIL.Image"):
    sys.modules[name] = None
sys.path.insert(0, %r)
import numpy as np
import torch
from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig, FCNLectureNet
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.server import BinarizeService, decode_image
from lecturemath_tpu_torch.utils.png import decode_png_gray, encode_png
from lecturemath_tpu_torch.utils.synthetic import threshold_binarizer_variables
cfg = FCNConfig(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
                upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
                pixel_features=(3, 2), kernel_size=3, pixel_kernel_size=3)
model = FCNLectureNet(cfg)
model.load_state_dict(threshold_binarizer_variables(cfg))
service = BinarizeService(Binarizer(model, device="cpu", upload_format="yuv420"),
                          model_size=(64, 48), max_batch=2)
frame = np.full((96, 130, 3), 220, np.uint8)
frame[20:40, 24:60] = 20
for size in ((96, 130), (48, 64), (60, 80), (30, 40)):
    rgb = decode_image(encode_png(frame[:size[0], :size[1], ::-1]))
    binary = decode_png_gray(encode_png(service.binarize_rgb(rgb)))
    assert binary.shape == size and (binary == 0).any()
service.close()
print("serving ok")
"""


def test_serving_path_needs_no_opencv():
    """Request decode, area resize to the bucket (2x, fractional and up),
    I420 upload, nearest resize back and answer encode run with cv2 and PIL
    unimportable, as on a machine that has neither."""
    result = subprocess.run(
        [sys.executable, "-c", _SERVING_NO_OPENCV % REPO], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "serving ok" in result.stdout


EVAL_MODULES = [
    "lecturemath_tpu_torch.ops.overlap",
    *[f"lecturemath_tpu_torch.eval.{name}" for name in (
        "aligner", "annotation", "evaluator", "keyframe_bin",
        "lecture_annotation", "segments_eval", "summary_eval",
        "text_detector_eval")],
    "lecturemath_tpu_torch.eval",
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "eval_summaries", "eval_segments", "eval_text_detector")],
]


@pytest.mark.parametrize("module", EVAL_MODULES)
def test_eval_slice_modules_are_checked(module):
    """The evaluation modules, the overlap ops and the three evaluation
    CLIs are among the files the checks above walk."""
    assert module in [_module_name(p) for p in _port_files()]


_EVAL_NO_OPENCV = r"""
import sys
for name in ("cv2", "PIL", "PIL.Image", "matplotlib", "matplotlib.path",
             "msgpack"):
    sys.modules[name] = None
sys.path.insert(0, %r)
import torch
from lecturemath_tpu_torch.cli import eval_segments, eval_summaries
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.eval.keyframe_bin import \
    evaluate_keyframe_binarization
from lecturemath_tpu_torch.eval.lecture_annotation import \
    polygon_intersection_area
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from_config = Binarizer.from_config
Binarizer.from_config = lambda config, **kw: from_config(
    config, **dict(kw, dtype=torch.float32))
summary_conf, kb_conf, model = %r
eval_summaries.main(["eval_summaries", summary_conf])
eval_segments.main(["eval_segments", summary_conf, "1"])
config = Config.from_file(kb_conf)
config.set("FCN_BINARIZER_SAVE_BINARY_PATH", %r)
scope_metrics, scopes, pixel = evaluate_keyframe_binarization(
    config, model, "training", save_binaries=True, device="cpu")
assert 0 < pixel["recall"] <= 1 and "all" in scopes
star = [[0, 0], [10, 4], [4, 6], [6, 14], [0, 6]]
assert polygon_intersection_area(star, [[c[1], c[0]] for c in star]) > 0
print("eval ok")
"""


def test_eval_path_needs_no_opencv(tmp_path):
    """Summary, segment and keyframe-binarization evaluation on a PNG GT
    tree, with polygon objects and the non-convex overlap, run with cv2,
    PIL and matplotlib unimportable, as on a machine that has none of
    them."""
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables

    import _torch_eval_tree as tree

    summary_conf = tree.summary_tree(str(tmp_path / "summary"))
    kb_conf = tree.keyframe_bin_tree(str(tmp_path / "kb"))
    cfg = FCNConfig.from_config(Config.from_file(kb_conf))
    model = str(tmp_path / "threshold.dat")
    save_checkpoint(threshold_binarizer_variables(cfg), model)
    script = _EVAL_NO_OPENCV % (REPO, (summary_conf, kb_conf, model),
                                str(tmp_path / "saved"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            capture_output=True, text=True, timeout=300,
                            env=env)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "eval ok" in result.stdout and "SIoU" in result.stdout
    assert "Finished" in result.stdout
    assert (tmp_path / "saved" / "FCN" / "kb01" / "binary" / "500.png") \
        .exists()


HOST_MODULES = [
    *[f"lecturemath_tpu_torch.cli.{name}" for name in (
        "cc_analysis", "cc_grouping", "vid_segmentation", "generate_summary")],
    "lecturemath_tpu_torch.eval.gt_authoring",
]


def test_host_steps_start_without_torch():
    """Stages 02-05's CLIs and GT authoring load no torch when imported:
    the binarizer (and torch with it) loads where a lecture is binarized or
    labeled on the card. On the card's machine importing torch takes
    seconds of each host step's start."""
    code = (f"import importlib, sys; sys.path.insert(0, {REPO!r}); "
            f"[importlib.import_module(m) for m in {HOST_MODULES!r}]; "
            f"print('torch' in sys.modules)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip() == "False"
