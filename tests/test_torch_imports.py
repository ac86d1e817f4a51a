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
