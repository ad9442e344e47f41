"""The port's CLI (``python -m mdx_torch``) on the CPU.

* ``main([...], device="cpu")`` against the JAX package's ``main.py`` on
  the same file and flags: the same exit code, the same printed report
  with its numbers masked (the sweep's rationale mapped as in
  ``test_torch_pipeline.py``), and the numbers of the DB rows the two runs
  wrote within ``mdx_torch.parity``;
* the flags the port refuses (``--genai``, ``--plan-only``), a JPEG 2000
  input and a missing file exit 1 with main.py's prefixes
  (``--spatial`` runs: ``tests/test_torch_spatial_runner.py``);
* ``.env`` loading and ``--tv-mode`` / ``MDX_TV_MODE``, read once and passed
  on as ``tv_mode``;
* with JAX, jaxlib, pydantic and matplotlib blocked, a CLI run end to end
  (single file, a JPEG Lossless file, autotune, batch, spatial) in a fresh
  process;
* without a card, the default ``device="cuda"`` raises before the file is
  read, in-process and as ``python -m mdx_torch``;
* nothing in the port imports mdx, JAX, bench, pydantic or matplotlib.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import main as jax_main
from mdx.io import dicom_write as JW
from mdx.io.dicom import TS_J2K_LOSSLESS, TS_JPEG_BASELINE
from mdx_torch import __main__ as cli
from mdx_torch import parity
from mdx_torch.io import write_synthetic_dicom

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.delenv("MDX_TV_MODE", raising=False)
    return tmp_path / "runs.db"


def _outputs(capsys, argv):
    """(rc, stdout) of main.py and of the port's main on ``argv``."""
    rc_j = jax_main.main(argv)
    out_j = capsys.readouterr().out
    rc_p = cli.main(argv, device="cpu")
    out_p = capsys.readouterr().out
    return (rc_j, out_j), (rc_p, out_p)


def _rows_tree(rows: list[dict]) -> dict:
    """DB rows of one run (or one batch) → parity's names."""
    mb = {k: np.array([r["metrics_before"][k] for r in rows])
          for k in rows[0]["metrics_before"]}
    tree = {"stats": mb, "validation": {"metrics_before": mb}}
    if rows[0]["metrics_after"]:
        tree["validation"]["metrics_after"] = {
            k: np.array([r["metrics_after"][k] for r in rows])
            for k in rows[0]["metrics_after"]}
    return parity.flatten(tree)


@pytest.mark.parametrize("flags", [[], ["--autotune"], ["--batch"],
                                   ["--batch", "--window"]])
def test_output_and_exit_code_match_main_py(tmp_path, db, capsys, flags):
    """The same printed text with its numbers masked; the numbers are held
    to ``mdx_torch.parity`` through the DB rows each run wrote."""
    from mdx_torch.pipeline import storage

    path = write_synthetic_dicom(str(tmp_path / "noisy.dcm"), kind="noisy",
                                 size=64, frames=2 if "--batch" in flags
                                 else 1)
    argv = ["--input", path, "--output", str(tmp_path / "out"),
            "--no-show", *flags]
    (rc_j, out_j), (rc_p, out_p) = _outputs(capsys, argv)
    assert rc_j == rc_p == 0
    out_j = out_j.replace("one compiled program", "one batched pass")
    assert out_p.startswith("# ") and len(out_p) > 200
    assert parity._NUMBER.sub("#", out_p) == parity._NUMBER.sub("#", out_j)
    runs = sorted((storage.get_run(r["run_id"]) for r in storage.list_runs()),
                  key=lambda r: (r["created_at"], r["input_filename"]))
    n = len(runs) // 2
    assert n == (2 if "--batch" in flags else 1)
    jax_rows, port_rows = runs[:n], runs[n:]
    assert [r["input_filename"] for r in jax_rows] == [
        r["input_filename"] for r in port_rows]
    assert not parity.breaches(_rows_tree(port_rows), _rows_tree(jax_rows),
                               hw=64 * 64)


def test_refused_flags_and_inputs_exit_1(tmp_path, db, capsys):
    path = write_synthetic_dicom(str(tmp_path / "x.dcm"), size=32)
    for flag, words in (("--genai", "GenAI mode is not part of mdx_torch"),
                        ("--plan-only", "GenAI mode is not part of mdx_torch")):
        assert cli.main(["--input", path, flag], device="cpu") == 1
        out = capsys.readouterr().out
        assert out.startswith("ERROR: ") and words in out, out
    # a DCT JPEG file: the .4.90 file with its UID rewritten (both 22
    # characters); the port does not decode .4.50 yet
    j2k = JW.write_dicom(str(tmp_path / "j2k.dcm"),
                         np.arange(256, dtype=np.uint16).reshape(16, 16),
                         transfer_syntax=TS_J2K_LOSSLESS)
    dct = str(tmp_path / "dct.dcm")
    with open(dct, "wb") as f:
        f.write(open(j2k, "rb").read().replace(TS_J2K_LOSSLESS.encode(),
                                                TS_JPEG_BASELINE.encode()))
    assert cli.main(["--input", dct, "--output", str(tmp_path / "o")],
                    device="cpu") == 1
    out = capsys.readouterr().out
    assert re.match(r"ERROR: transfer syntax 1\.2\.840\.10008\.1\.2\.4\.50 "
                    r"\(JPEG Baseline\) is not yet in mdx_torch", out), out
    missing = ["--input", str(tmp_path / "nope.dcm"), "--output",
               str(tmp_path / "o"), "--no-show"]
    (rc_j, out_j), (rc_p, out_p) = _outputs(capsys, missing)
    assert rc_j == rc_p == 1
    assert out_p == out_j == "Error: Invalid or missing DICOM file.\n"


def test_dotenv_and_tv_mode(tmp_path, db, monkeypatch, capsys):
    path = write_synthetic_dicom(str(tmp_path / "x.dcm"), size=32)
    seen = []
    from mdx_torch.pipeline import runner

    real = runner.run_pipeline

    def spy(*a, **kw):
        seen.append(kw["tv_mode"])
        return real(*a, **kw)

    monkeypatch.setattr(runner, "run_pipeline", spy)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MDX_DB_PATH")
    (tmp_path / ".env").write_text(
        "# settings\nMDX_DB_PATH='env.db'\nMDX_TV_MODE=fast\nNOEQUALS\n")
    try:
        assert cli.main(["--input", path, "--output", "o"],
                        device="cpu") == 0
        assert (tmp_path / "env.db").exists()
        assert cli.main(["--input", path, "--output", "o", "--tv-mode",
                         "ref"], device="cpu") == 0
    finally:
        os.environ.pop("MDX_TV_MODE", None)
        os.environ.pop("NOEQUALS", None)
    assert seen == ["fast", "ref"]
    assert "# " in capsys.readouterr().out


def _run(code: str, cwd, timeout=600, args=()):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["MDX_DB_PATH"] = str(Path(cwd) / "runs.db")
    return subprocess.run([sys.executable, *args, "-c", code] if code else
                          [sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_runs_with_jax_pydantic_matplotlib_blocked(tmp_path):
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pydantic",
                                          "matplotlib"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import io, contextlib, os
        import torch
        torch.set_num_threads(1)
        from mdx_torch.__main__ import main
        from mdx_torch.io import native, write_synthetic_dicom
        from mdx_torch.io.dicom import TS_JPEG_LL_SV1
        from mdx_torch.io.visuals import read_png
        from mdx_torch.pipeline import storage
        os.makedirs("series", exist_ok=True)
        write_synthetic_dicom("x.dcm", kind="noisy", size=64)
        write_synthetic_dicom("ll.dcm", kind="phantom", size=64,
                              transfer_syntax=TS_JPEG_LL_SV1)
        write_synthetic_dicom("series/s.dcm", kind="phantom", size=64,
                              frames=3)
        outs = []
        for argv in (["--input", "x.dcm", "--output", "out", "--no-show"],
                     ["--input", "ll.dcm", "--output", "out", "--no-show"],
                     ["--input", "x.dcm", "--output", "out", "--autotune"],
                     ["--input", "series/s.dcm", "--output", "out",
                      "--batch"],
                     ["--input", "series/s.dcm", "--output", "out",
                      "--batch", "--resume"],
                     ["--input", "x.dcm", "--output", "out", "--spatial"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv, device="cpu") == 0, argv
            outs.append(buf.getvalue())
            assert outs[-1].startswith("# "), outs[-1][:300]
        assert read_png("out/x_before_after.png").shape == (64, 136)
        assert native.CALLS["jpegll_diffs"] == 1, native.CALLS
        assert "GenAI Plan (JSON)" in outs[2]
        assert outs[3].count("| s.dcm |") == 3
        assert "Frames processed: **0**" in outs[4]
        assert outs[5].startswith("# mdx spatial QA report")
        from mdx_torch.parallel import stream
        (start, frames), = stream.stream_batches(["x.dcm", "x.dcm"], 2,
                                                 device="cpu")
        assert start == 0 and tuple(frames.shape) == (2, 64, 64)
        runs = storage.list_runs()
        assert len(runs) == 3 + 3 + 1, runs
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pydantic",
                                      "matplotlib", "mdx", "bench")]
        assert not bad, bad
        print("OK")
    """)
    r = _run(code, tmp_path)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), \
        r.stderr[-3000:]


def test_default_device_raises_without_a_card(tmp_path, db):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from mdx_torch.pipeline.batch_runner import run_pipeline_batch
    from mdx_torch.pipeline.runner import run_pipeline
    from mdx_torch.pipeline.spatial_runner import run_pipeline_spatial

    missing = str(tmp_path / "never_read.dcm")
    for fn in (run_pipeline, run_pipeline_batch, run_pipeline_spatial):
        with pytest.raises(RuntimeError, match="device 'cuda'.*"
                                               "torch.cuda.is_available"):
            fn(missing, str(tmp_path / "o"))
    assert not (tmp_path / "o").exists() and not Path(db).exists()
    r = _run(None, tmp_path, args=("-m", "mdx_torch", "--input", missing,
                                   "--output", "o", "--no-show"))
    assert r.returncode == 1
    assert r.stdout.startswith("ERROR: mdx_torch runs on device 'cuda'"), \
        r.stdout + r.stderr[-2000:]
    assert not (tmp_path / "o").exists()


def test_port_imports_nothing_of_jax_pydantic_or_matplotlib():
    pattern = re.compile(r"^\s*(from|import) (mdx\b|mdx\.|bench|examples|"
                         r"jax|pydantic|matplotlib)")
    files = [ROOT / "chip_smoke.py", *(ROOT / "mdx_torch").rglob("*.py")]
    assert any(f.name == "__main__.py" for f in files)
    for path in files:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), f"{path}: {line}"


def test_pyproject_ships_every_port_package_and_kernel_source():
    """Every package under mdx_torch is listed, and every CUDA source the
    kernels and probes build from, and the host C++ source of the codecs,
    is package data."""
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]
    listed = set(cfg["setuptools"]["packages"])
    port = ROOT / "mdx_torch"
    packages = {".".join(p.relative_to(ROOT).parent.parts)
                for p in port.rglob("__init__.py")}
    assert {"mdx_torch.io", "mdx_torch.pipeline",
            "mdx_torch.parallel"} <= packages <= listed
    shipped = {f for g in cfg["setuptools"]["package-data"]["mdx_torch"]
               for f in port.glob(g)}
    sources = {f for f in (port / "csrc").rglob("*")
               if f.suffix in (".cu", ".cuh", ".cpp")}
    assert any(f.parent.name == "probes" for f in sources)
    assert port / "csrc" / "host" / "codecs.cpp" in sources
    assert sources <= shipped
