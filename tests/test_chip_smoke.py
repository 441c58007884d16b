"""chip_smoke.py's comparison helpers, its last line, and its refusal
to run anywhere but on a GPU."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "got, want, rtol, atol, passes",
    [
        ([1.0, 2.0], [1.0, 2.0], 1e-4, 1e-6, True),
        ([1.00005, 2.0], [1.0, 2.0], 1e-4, 0.0, True),
        ([1.0002, 2.0], [1.0, 2.0], 1e-4, 0.0, False),
        ([5e-7, 0.3], [0.0, 0.3], 1e-4, 1e-6, True),
        ([-np.inf, -3.0], [-np.inf, -3.00002], 1e-5, 0.0, True),
        ([-np.inf, -3.0], [-2.0, -3.0], 1e-5, 0.0, False),
    ],
)
def test_worst_error(smoke, got, want, rtol, atol, passes):
    ratio, max_abs, _ = smoke.worst_error(got, want, rtol, atol)
    assert (ratio <= 1.0) is passes
    assert max_abs >= 0.0


def _write(path, header, rows):
    with open(path, "w") as handle:
        handle.write("\t".join(header) + "\n")
        for row in rows:
            handle.write("\t".join(map(str, row)) + "\n")


def test_compare_tables_counts(smoke, tmp_path):
    header = ["Name", "ClusterID", "Length", "EffectiveLength", "ReadCount", "TPM"]
    want = [(f"t{i}", 1, 100, 90, float(i), 0) for i in range(50)]
    got = [(n, c, l, e, v * (1 + 1e-4 * (i % 3 - 1)), t) for i, (n, c, l, e, v, t) in enumerate(want)]
    got[10] = ("t10", 1, 100, 90, 10.0 + (got[11][4] - 11.0), 0)
    _write(tmp_path / "a.txt", header, got)
    _write(tmp_path / "b.txt", header, want)
    cmp = smoke.compare_tables(str(tmp_path / "a.txt"), str(tmp_path / "b.txt"))
    assert cmp["column"] == "ReadCount" and cmp["expressed"] == 49
    assert cmp["spearman"] > 0.9999
    _write(tmp_path / "c.txt", header, [(n, c, l, e, 49.0 - v, t) for n, c, l, e, v, t in want])
    bad = smoke.compare_tables(str(tmp_path / "c.txt"), str(tmp_path / "b.txt"))
    assert not smoke.table_passes(bad)


def test_compare_tables_haplotypes_missing_rows(smoke, tmp_path):
    header = ["Name_1", "Name_2", "ClusterID", "HaplotypingProbability"]
    want = [("a", "a", 1, 0.7), ("a", "b", 1, 0.3), ("c", "c", 2, 1.0)]
    _write(tmp_path / "a.txt", header, want)
    _write(tmp_path / "b.txt", header, want[:1] + want[2:])
    cmp = smoke.compare_tables(str(tmp_path / "a.txt"), str(tmp_path / "b.txt"))
    assert cmp["column"] == "HaplotypingProbability"
    assert cmp["rows"] == 3 and cmp["max_abs_err"] == pytest.approx(0.3)


def test_same_bytes(smoke, tmp_path):
    for prefix, text in (("x", "1\n"), ("y", "1\n"), ("z", "2\n")):
        (tmp_path / f"{prefix}.txt").write_text(text)
        (tmp_path / f"{prefix}_joint.txt").write_text("j\n")
    assert smoke.same_bytes(str(tmp_path / "x"), str(tmp_path / "y"))
    assert not smoke.same_bytes(str(tmp_path / "x"), str(tmp_path / "z"))
    assert not smoke.same_bytes(str(tmp_path / "nothing"), str(tmp_path / "nil"))


@pytest.mark.parametrize("count", [1, 4])
def test_result_line(smoke, count):
    line = smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_a_gpu(tmp_path, where):
    """On a CPU-only host, and as a lone file without the repo, the
    script fails and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
