"""No run loads JAX or the JAX package, and the reference loads nothing of
the program.  Top-level names are compared whole: ``mdx_torch`` is not
``mdx``."""

import subprocess
import sys

import pytest
from conftest import BENCH, REPO

from mdxbench import guard


def test_loaded_compares_whole_top_level_names():
    mods = ["mdx_torch", "mdx_torch.core.qa", "jaxtyping", "mdxbench",
            "numpy"]
    assert guard.loaded(modules=mods) == []
    assert guard.loaded(modules=mods + ["mdx.core", "jax", "jaxlib.xla",
                                        "flax.linen", "mdx"]) == [
        "flax.linen", "jax", "jaxlib.xla", "mdx", "mdx.core"]


def test_sources_import_no_jax():
    roots = guard.imported_roots(BENCH)
    assert not roots & set(guard.FORBIDDEN), roots


def test_reference_imports_nothing_of_the_program():
    roots = guard.imported_roots(BENCH / "reference")
    assert "mdx_torch" not in roots and not roots & set(guard.FORBIDDEN)
    assert roots <= {"__future__", "struct", "numpy", "torch", "reference"}


@pytest.mark.parametrize("modules", [
    "reference.qa, reference.dicom",
    "mdxbench.cell, mdxbench.check, mdxbench.tracing, control",
])
def test_loading_loads_no_forbidden_module(modules):
    """In a fresh process: what the harness and the program load."""
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]\n"
            f"import {modules}\n"
            "import mdx_torch.pipeline.batch_runner, "
            "mdx_torch.pipeline.runner, mdx_torch.core.tuning\n"
            "from mdxbench import guard\n"
            "print(guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=REPO)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    if modules.startswith("reference"):
        code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
                f"import {modules}\n"
                "print(sorted(m for m in sys.modules "
                "if m.split('.')[0] == 'mdx_torch'))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300,
                             check=True, cwd=BENCH)
        assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_needs_the_program(tmp_path):
    """In a folder with only BENCHMARK.json and the benchmark's files, a
    run exits with another code than 0 and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ct512.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
