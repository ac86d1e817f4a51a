"""The port's run-book wrappers (scripts_torch/) and console scripts against
the JAX package's (scripts/, the lecturemath-* entries of pyproject.toml):
the same 18 file names, each forwarding to the port's counterpart of its
JAX twin's module, and a ``lecturemath-torch-*`` console script for every
JAX one."""

import ast
import importlib
import os
import py_compile
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")
PORT_SCRIPTS = os.path.join(REPO, "scripts_torch")


def _names(directory):
    return sorted(name for name in os.listdir(directory)
                  if name.endswith(".py"))


def _main_module(path):
    """The module a wrapper takes ``main`` from (its one ``from X import
    main``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom)
             and [alias.name for alias in node.names] == ["main"]]
    assert len(found) == 1, (path, found)
    return found[0]


def test_the_same_eighteen_file_names():
    names = _names(PORT_SCRIPTS)
    assert names == _names(JAX_SCRIPTS)
    assert len(names) == 18
    assert "pre_ST3D_v3.0_02_cc_analaysis.py" in names
    assert "pre_ST3D_v3.0_02_cc_analysis.py" in names
    assert "vis_gt_invervals.py" in names


@pytest.mark.parametrize("name", _names(JAX_SCRIPTS))
def test_wrapper_forwards_to_the_port_counterpart(name):
    path = os.path.join(PORT_SCRIPTS, name)
    py_compile.compile(path, doraise=True)
    jax_module = _main_module(os.path.join(JAX_SCRIPTS, name))
    module = _main_module(path)
    assert jax_module.startswith("lecturemath_tpu.")
    assert module == "lecturemath_tpu_torch." + jax_module[
        len("lecturemath_tpu."):]
    assert callable(importlib.import_module(module).main)


def test_typo_named_wrapper_prints_the_module_usage():
    """The reference's typo'd stage-02 name, run with no arguments, prints
    what ``python -m lecturemath_tpu_torch.cli.cc_analysis`` prints, its
    program name aside."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = os.path.join("scripts_torch", "pre_ST3D_v3.0_02_cc_analaysis.py")
    runs = [subprocess.run([sys.executable] + cmd, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
            for cmd in ([script],
                        ["-m", "lecturemath_tpu_torch.cli.cc_analysis"])]
    assert [run.returncode for run in runs] == [0, 0], runs[0].stderr[-2000:]
    texts = [run.stdout for run in runs]
    assert texts[0].startswith(f"Usage: python {script} config")
    assert "Usage" in texts[1]
    program = texts[1].splitlines()[0].split()[2]
    assert program.endswith(os.path.join("cli", "cc_analysis.py"))
    assert texts[0].replace(script, "<program>", 1) == texts[1].replace(
        program, "<program>", 1)


def _console_scripts():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    section = text.split("[project.scripts]")[1].split("\n[")[0]
    return dict(re.findall(r'^(\S+) = "([\w.:]+)"', section, re.M))


def test_every_jax_console_script_has_a_port_twin():
    scripts = _console_scripts()
    jax = {name: target for name, target in scripts.items()
           if target.startswith("lecturemath_tpu.")}
    assert len(jax) == 13
    for name, target in jax.items():
        twin = "lecturemath-torch-" + name[len("lecturemath-"):]
        assert scripts.get(twin) == "lecturemath_tpu_torch." + target[
            len("lecturemath_tpu."):], name
    port = [name for name in scripts if name.startswith("lecturemath-torch-")]
    assert len(port) == len(jax)
