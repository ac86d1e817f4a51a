"""The check that no module of JAX or the JAX package is loaded compares
top-level names whole."""

import sys
import types

from benchmark.harness import forbidden_modules


def test_port_passes_and_jax_package_fails(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "lecturemath_tpu"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "lecturemath_tpu_torch_probe",
                        types.ModuleType("lecturemath_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe",
                        types.ModuleType("jaxtyping_probe"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lecturemath_tpu.models",
                        types.ModuleType("lecturemath_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert forbidden_modules() == ["jaxlib", "lecturemath_tpu"]


def test_harness_imports_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness, benchmark.drivers.express,"
            " benchmark.drivers.stage01,"
            " benchmark.drivers.train, benchmark.control;"
            "from benchmark.harness import forbidden_modules;"
            "print(forbidden_modules())")
    from benchmark.harness import ROOT

    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
