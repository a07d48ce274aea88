"""Smoke-run the example pipeline end to end on CPU (tiny shapes).

The examples are user-facing entry points; a broken import or API drift
there should fail CI, not a user.
"""

import runpy
import sys
from pathlib import Path

import jax
import pytest


@pytest.fixture(autouse=True)
def _keep_compile_cache_config():
    """The entry scripts turn on the persistent compile cache; keep that
    from leaking into the tests that share this worker process."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_pipeline_smoke(capsys, monkeypatch):
    root = Path(__file__).resolve().parent.parent
    monkeypatch.setattr(sys, "argv", [
        "pipeline.py", "--n", "4000", "--d", "32", "--m", "8",
        "--bits", "4", "--iters", "3", "--queries", "4",
        "--ivf", "16", "--virtual",
    ])
    runpy.run_path(str(root / "examples" / "pipeline.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "recall@10 of the planted nearest neighbor:" in out
    assert "virtual: search + exact-refine recall@10:" in out
    # Tiny-scale runs must still find their planted neighbors.
    for line in out.splitlines():
        if "recall@10" in line:
            assert float(line.rsplit(" ", 1)[1]) >= 0.75, line


def test_scaling_real_path_smoke(capsys, monkeypatch, tmp_path):
    # The --real branch of benches/scaling.py is written for real cards,
    # where jax.devices() is the real mesh.  Under the conftest's 8-device
    # virtual CPU mesh it executes the identical code path (real key
    # names, real reps schedule), so a multi-card run cannot be its
    # first-ever execution.  --max-devices keeps the smoke fast.
    import json

    root = Path(__file__).resolve().parent.parent
    out_file = tmp_path / "scaling.json"
    monkeypatch.setattr(sys, "argv", [
        "scaling.py", "--real", "--max-devices", "2",
        "--out", str(out_file),
    ])
    runpy.run_path(str(root / "benches" / "scaling.py"), run_name="__main__")
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    bench_rows = [r for r in rows if r.get("bench", "").startswith("scaling_")
                  and "devices" in r]
    assert {r["devices"] for r in bench_rows} == {1, 2}
    for r in bench_rows:
        assert r["virtual_mesh"] is False
        assert "weak_efficiency" in r and "strong_efficiency" in r
        assert r["weak_ms_per_iter"] > 0


def test_pipeline_disk_smoke(capsys, monkeypatch):
    # The fully disk-resident lifecycle (--disk): streamed training, IVF
    # train/build straight from the on-disk reader, disk-backed refine.
    root = Path(__file__).resolve().parent.parent
    monkeypatch.setattr(sys, "argv", [
        "pipeline.py", "--n", "4000", "--d", "32", "--m", "8",
        "--bits", "4", "--iters", "3", "--queries", "4",
        "--ivf", "16", "--disk",
    ])
    runpy.run_path(str(root / "examples" / "pipeline.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "disk: streamed PQ training in" in out
    assert "disk: IVF build from reader in" in out
    for line in out.splitlines():
        if "disk: IVF + disk-refine recall@10:" in line:
            assert float(line.rsplit(" ", 1)[1]) >= 0.75, line
            break
    else:
        raise AssertionError("disk refine line missing:\n" + out)


def test_pipeline_opq_smoke(capsys, monkeypatch):
    # OPQ flavor of the example: rotation learned, persisted, reloaded.
    root = Path(__file__).resolve().parent.parent
    monkeypatch.setattr(sys, "argv", [
        "pipeline.py", "--n", "3000", "--d", "32", "--m", "8",
        "--bits", "4", "--iters", "3", "--queries", "4", "--opq",
    ])
    runpy.run_path(str(root / "examples" / "pipeline.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "trained OPQ" in out
    for line in out.splitlines():
        if "recall@10 of the planted nearest neighbor:" in line:
            assert float(line.rsplit(" ", 1)[1]) >= 0.75, line


def test_serving_example_smoke(capsys, monkeypatch):
    # Serving lifecycle: L2 + MIPS over one index, live updates, sharded
    # exhaustive scan.
    root = Path(__file__).resolve().parent.parent
    monkeypatch.setattr(sys, "argv", [
        "serving.py", "--n", "8000", "--d", "32", "--m", "8",
        "--bits", "4", "--cells", "32", "--queries", "8",
    ])
    runpy.run_path(str(root / "examples" / "serving.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "MIPS IVF+refine" in out and "sharded exhaustive scan" in out
    for marker in ("top-1 self-hit", "new rows retrievable",
                   "agreement with single-device"):
        line = next(l for l in out.splitlines() if marker in l)
        val = float(line.split(marker)[1].strip(" :").rstrip(")").split()[0])
        assert val >= 0.9, line
