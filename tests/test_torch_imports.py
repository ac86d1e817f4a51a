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
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PACKAGE)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


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
import importlib, os, sys
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
print("imported", len(%r))
"""


def test_every_port_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()
               if not p.endswith("chip_smoke.py")]
    script = _BLOCKED_IMPORT % (BANNED, REPO, modules, modules)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            capture_output=True, text=True, timeout=120,
                            env=env)
    assert result.returncode == 0, result.stderr[-3000:]
    assert f"imported {len(modules)}" in result.stdout


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
