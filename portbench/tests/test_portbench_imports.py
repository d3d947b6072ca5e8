"""Nothing the benchmark runs loads JAX or the JAX package: the guard
compares top-level names whole, and a process that imports every module of
the harness, its drivers, its reference and the parts of the port they call
holds none of them."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import REPO


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["ttamm_torch", "ttamm_torch.ops", "jaxtyping", "flaxen",
                                      "ttamm_tpu_extra", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "ttamm_tpu.ops"]) == \
        ["flax", "jax", "jaxlib", "ttamm_tpu"]


def test_harness_and_the_port_it_drives_load_no_jax():
    code = """
import sys
sys.path.insert(0, %r)
import portbench.harness, portbench.calibrate, portbench.corpus, portbench.weights
import portbench.drivers.train_epochs, portbench.drivers.search_batches
import portbench.reference.train_step, portbench.reference.search, portbench.reference.compare
import ttamm_torch.train.step, ttamm_torch.train.state, ttamm_torch.serve.flat_index
import ttamm_torch.pipelines.training, ttamm_torch.pipelines.export, ttamm_torch.data
print(portbench.harness.forbidden_modules())
""" % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(REPO / "portbench" / ".cache")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "ttamm" not in text.replace("ttamm_torch/", ""), path
        assert "import jax" not in text and "from jax" not in text, path


def _run_py(cwd):
    return subprocess.run([sys.executable, str(cwd / "portbench" / "run.py"), "--workload", "default.train",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=600)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the card's case is the test below
    out = _run_py(REPO)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_run_from_the_benchmark_files_alone_prints_no_result(card, tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's paths has no
    program to run."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns(".cache"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
