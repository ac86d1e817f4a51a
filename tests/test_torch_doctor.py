"""The port's doctor CLI (lecturemath_tpu_torch.cli.doctor): the
scenarios of tests/test_doctor.py, with ``-device cpu`` where the machine
has no card (the card and its kernels are then not needed), and the CUDA
checks that replace the JAX backend probe."""

import os

import pytest
import torch

from lecturemath_tpu_torch.cli.doctor import main
from lecturemath_tpu_torch.core import backend_probe
from lecturemath_tpu_torch.ops import cuda_build

DB_XML = """<AccessMath><DataBase><Name>DRDB</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Testing><LectureTitle>dr01</LectureTitle></Testing></Datasets>
<Lectures><Lecture><Id>dr01</Id><Title>dr01</Title><Parameters></Parameters>
<Videos><Main><Video><Path>dr01.mp4</Path></Video></Main></Videos>
</Lecture></Lectures></DataBase></AccessMath>
"""


def _workspace(tmp_path, with_video=True):
    (tmp_path / "db.xml").write_text(DB_XML)
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "m.dat").write_bytes(b"\x80")
    if with_video:
        (tmp_path / "videos").mkdir()
        (tmp_path / "videos" / "dr01.mp4").write_bytes(b"x")
    conf = tmp_path / "dr.conf"
    conf.write_text(
        f"VIDEO_DATABASE_PATH = {tmp_path}/db.xml\n"
        f"VIDEO_FILES_PATH = {tmp_path}/videos\n"
        f"OUTPUT_PATH = {tmp_path}/output\n"
        f"BINARIZATION_FCN_LECTURENET_DIR = {tmp_path}/models\n"
        "BINARIZATION_FCN_LECTURENET_FILENAME = m.dat\n")
    return str(conf)


def test_doctor_workspace_passes(tmp_path, capsys):
    assert main(["prog", _workspace(tmp_path), "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("[PASS] device backend: not needed (-device cpu)",
                 "[PASS] CUDA kernels: not needed (-device cpu)",
                 "[PASS] config parses", "[PASS] lecture database",
                 "[PASS] video inputs", "[PASS] model checkpoint",
                 "[PASS] output tree", "ALL CHECKS PASSED"):
        assert line in out, line


def test_doctor_missing_video_warns_not_fails(tmp_path, capsys):
    conf = _workspace(tmp_path, with_video=False)
    assert main(["prog", conf, "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[WARN] video inputs" in out and "dr01" in out


def test_doctor_bad_database_fails(tmp_path, capsys):
    conf = tmp_path / "bad.conf"
    conf.write_text("VIDEO_DATABASE_PATH = /nope/db.xml\n")
    assert main(["prog", str(conf), "-device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] lecture database" in out
    assert "CHECK(S) FAILED" in out


def test_doctor_missing_checkpoint_fails(tmp_path, capsys):
    conf = _workspace(tmp_path)
    os.remove(str(tmp_path / "models" / "m.dat"))
    assert main(["prog", conf, "-device", "cpu"]) == 1
    assert "[FAIL] model checkpoint" in capsys.readouterr().out


def test_doctor_bad_database_still_reports_config_scoped_checks(tmp_path,
                                                                capsys):
    conf = tmp_path / "bad.conf"
    conf.write_text("VIDEO_DATABASE_PATH = /nope/db.xml\n"
                    f"OUTPUT_PATH = {tmp_path}/out\n")
    assert main(["prog", str(conf), "-device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] lecture database" in out
    assert "[FAIL] model checkpoint" in out     # still reported
    assert "[PASS] output tree" in out


def test_doctor_probe_opt_out_never_touches_the_card(monkeypatch, capsys):
    """With the probe opted out the doctor must not touch CUDA unbounded;
    the kernels' build (nvcc, no card) still runs."""
    def boom(*args):
        raise AssertionError("doctor must not touch the card")

    monkeypatch.setattr(backend_probe, "_probe_cuda", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    built = []
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "/usr/local/cuda/nvcc")
    monkeypatch.setattr(cuda_build, "build", lambda: built.append(1) or {})
    monkeypatch.setenv("LM_DEVICE_PROBE_TIMEOUT_S", "0")
    assert main(["prog"]) == 0
    out = capsys.readouterr().out
    assert "probe skipped" in out
    assert "[PASS] CUDA kernels: libthreshold_pack.so, libconv7.so, " \
           "libcc_label.so" in out
    assert built == [1]


def test_doctor_environment_only(capsys):
    assert main(["prog", "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] device backend" in out
    assert "[PASS] native C++ kernels" in out


def test_doctor_kernels_fail_without_nvcc(monkeypatch, capsys):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lecturemath_tpu_torch need the CUDA toolkit")

    monkeypatch.setattr(cuda_build, "nvcc", no_nvcc)
    monkeypatch.setenv("LM_DEVICE_PROBE_TIMEOUT_S", "0")
    assert main(["prog"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] CUDA kernels: nvcc not found" in out
    assert "1 CHECK(S) FAILED" in out


def test_doctor_device_backend_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["prog"]) == 1
    assert "[FAIL] device backend: CUDA device failed to initialize" in \
        capsys.readouterr().out
