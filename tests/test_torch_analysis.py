"""The results readers (tools/analysis.py, tools/report.py) against the JAX
package's: the CSVs that the port's simulator writes for a tiny CPU job,
and benchmark grids as JSON lines made here, read by both packages to equal
results; the figures render to PNG; the HTML report is character-equal
under the same title; both CLIs exit 0."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_tpu.tools import analysis as janalysis  # noqa: E402
from polar_codes_tpu.tools import report as jreport  # noqa: E402
from polar_codes_torch.sim import cli as tcli  # noqa: E402
from polar_codes_torch.tools import analysis  # noqa: E402
from polar_codes_torch.tools import report  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = ["-n", "64", "-r", "0.5", "-e", "crc8", "--batch", "64", "--snr-min", "0",
       "--snr-max", "3", "--snr-count", "3", "--platform", "cpu"]
PNG = b"\x89PNG\r\n\x1a\n"


def _row(bench, n, k, thr, **extra):
    return {"bench": bench, "N": n, "K": k, "batch": 128, "seconds_per_batch": n * 1e-7,
            "code_thr_mbps": thr * n / k, "info_thr_mbps": thr, "bound": "latency", **extra}


GRID_A = [
    _row("encode_n1024", 1024, 512, 9000.0),
    _row("fastssc_float_n256", 256, 128, 800.0),
    _row("fastssc_float_n1024", 1024, 512, 1200.0),
    _row("fastssc_char_n1024", 1024, 512, 1300.0, dtype="char"),
    _row("cascl_float_n256_l8", 256, 128, 90.0, L=8),
    _row("cascl_float_n1024_l8", 1024, 512, 110.0, L=8),
    _row("cascl_float_n1024_l8_b2048", 1024, 512, 150.0, L=8),
    _row("scan_float_n1024_l4", 1024, 512, 300.0, L=4),
    _row("sc_scan_n32768", 32768, 16384, 400.0),
    _row("cascl_scan_n32768_l8", 32768, 16384, 20.0, L=8),
    {"bench": "cascl_float_n4096_l32", "error": "RESOURCE_EXHAUSTED"},
]
GRID_B = [
    _row("encode_n1024", 1024, 512, 9900.0),
    _row("fastssc_float_n1024", 1024, 512, 1000.0),
    {"bench": "fastssc_float_n1024", "error": "retried and failed"},  # keeps the measurement
    _row("cascl_float_n1024_l8", 1024, 512, 100.0, L=8),
    _row("cascl_float_n1024_l8", 1024, 512, 120.0, L=8),  # the last measurement wins
    _row("cascl_float_n256_l8", 256, 128, 95.0, L=8),
    _row("sc_scan_n32768", 32768, 16384, 380.0),
    _row("cascl_float_n4096_l32", 4096, 2048, 40.0, L=32),
    {"no_bench": 1},
]


def _write_jsonl(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
        fh.write("{not json\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two CSVs of the port's simulator (a list-length sweep and a single
    job twice over, at two workloads) and two grids."""
    d = tmp_path_factory.mktemp("readers")
    assert tcli.main(["listlength", *JOB, "--l-min", "1", "--l-max", "4", "-w", "4096",
                      "-o", str(d / "a")]) == 0
    assert tcli.main(["single", *JOB, "-l", "2", "-w", "4096", "-o", str(d / "b")]) == 0
    assert tcli.main(["single", *JOB, "-l", "2", "-w", "8192", "-o", str(d / "c")]) == 0
    return {"lists": str(d / "a_listlength.csv"), "single": str(d / "b_single.csv"),
            "single2": str(d / "c_single.csv"),
            "grid_a": _write_jsonl(d / "grid_a.jsonl", GRID_A),
            "grid_b": _write_jsonl(d / "grid_b.jsonl", GRID_B), "dir": d}


def _assert_same(got, want):
    """Equal nested results, NumPy arrays and NaN included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("which", ["lists", "single"])
def test_csv_readers_equal_jax(files, which):
    rows = analysis.read_results_csv(files[which])
    assert len(rows) >= 3 and len(rows[0]) == 23
    _assert_same(rows, janalysis.read_results_csv(files[which]))
    summary = analysis.summarize_results(rows)
    _assert_same(summary, janalysis.summarize_results(rows))
    assert len(summary) == (3 if which == "lists" else 1)  # L = 1, 2, 4


def test_merge_results_equals_jax(files):
    lists = [analysis.read_results_csv(files[k]) for k in ("single", "single2", "lists")]
    merged = analysis.merge_results(lists)
    _assert_same(merged, janalysis.merge_results(
        [janalysis.read_results_csv(files[k]) for k in ("single", "single2", "lists")]))
    # the single jobs' points merge: runs add up, rates are the runs-weighted mean
    a, b = lists[0][0], lists[1][0]
    point = next(r for r in analysis.merge_results(lists[:2]) if r["Eb/N0"] == a["Eb/N0"])
    assert point["Runs"] == a["Runs"] + b["Runs"]
    assert point["BLER"] == pytest.approx(
        (a["BLER"] * a["Runs"] + b["BLER"] * b["Runs"]) / (a["Runs"] + b["Runs"]))


@pytest.mark.parametrize("name", [r["bench"] for r in GRID_A] + [
    "cascl_pallas_char_n2048_l16", "fastssc_pallas_n512", "adaptive_n1024_l8_crc32",
    "not-a-grid-name"])
def test_parse_bench_name_equals_jax(name):
    _assert_same(analysis.parse_bench_name(name), janalysis.parse_bench_name(name))


def test_grid_readers_equal_jax(files):
    rows_a = analysis.load_benchmark_jsonl(files["grid_a"])
    rows_b = analysis.load_benchmark_jsonl(files["grid_b"])
    _assert_same(rows_a, janalysis.load_benchmark_jsonl(files["grid_a"]))
    _assert_same(rows_b, janalysis.load_benchmark_jsonl(files["grid_b"]))
    by_name = {r["bench"]: r for r in rows_b}
    assert by_name["cascl_float_n1024_l8"]["info_thr_mbps"] == 120.0
    assert "error" not in by_name["fastssc_float_n1024"]
    cmp = analysis.compare_grids(rows_a, rows_b)
    _assert_same(cmp, janalysis.compare_grids(rows_a, rows_b))
    assert [r["bench"] for r in cmp][0] == "fastssc_float_n1024"  # sorted by ratio
    for family, dtype in (("cascl", "float"), ("fastssc", "float"), ("fastssc", "char"),
                          ("sc_scan", "float"), ("scan", "float")):
        _assert_same(analysis.throughput_over_info_length(rows_a, family, dtype),
                     janalysis.throughput_over_info_length(rows_a, family, dtype))


def test_plots_render_to_png(files, tmp_path):
    rows = analysis.read_results_csv(files["lists"])
    grid = analysis.load_benchmark_jsonl(files["grid_a"])
    figures = {
        "bler": lambda p: analysis.plot_bler_curves(rows, p),
        "overlay": lambda p: analysis.plot_bler_overlay(
            rows, analysis.read_results_csv(files["single"]), path=p),
        "combo": lambda p: analysis.plot_fer_throughput_combo(rows, p),
        "grid": lambda p: analysis.plot_grid_throughput(grid, p),
    }
    for name, draw in figures.items():
        path = str(tmp_path / f"{name}.png")
        assert draw(path) is not None
        with open(path, "rb") as fh:
            assert fh.read(8) == PNG, name


@pytest.mark.parametrize("title", [report.DEFAULT_TITLE, "polar sweep"])
def test_render_report_equals_jax(files, tmp_path, title):
    inputs = [files["grid_a"], files["lists"], files["single"]]
    ours = report.render_report(inputs, str(tmp_path / "ours.html"), title)
    theirs = jreport.render_report(inputs, str(tmp_path / "theirs.html"), title)
    with open(ours) as a, open(theirs) as b:
        html = a.read()
        assert html == b.read()
    assert html.count("<svg") >= 4 and f"<h1>{title}</h1>" in html
    if title == report.DEFAULT_TITLE:  # the default title names the port
        assert "polar_codes_torch" in title
        report.render_report(inputs, str(tmp_path / "default.html"))
        with open(tmp_path / "default.html") as fh:
            assert fh.read() == html


def test_clis_exit_zero(files, capsys):
    d = files["dir"]
    assert analysis.main(["overlay", files["lists"], files["single"], "-o",
                          str(d / "ov.png")]) == 0
    assert analysis.main(["fer-combo", files["single"], files["single2"], "-o",
                          str(d / "fc.png")]) == 0
    assert analysis.main(["grid-compare", files["grid_a"], files["grid_b"]]) == 0
    assert "geomean" in capsys.readouterr().out
    assert analysis.main(["grid-throughput", files["grid_a"], "-o", str(d / "gt.png")]) == 0
    for png in ("ov.png", "fc.png", "gt.png"):
        with open(d / png, "rb") as fh:
            assert fh.read(8) == PNG
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "polar_codes_torch.tools.report", files["grid_a"],
         files["lists"], "-o", str(d / "cli.html")], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "report written to" in out.stdout and (d / "cli.html").exists()
    out = subprocess.run(
        [sys.executable, "-m", "polar_codes_torch.tools.analysis", "grid-compare",
         files["grid_a"], files["grid_b"]], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "geomean" in out.stdout, out.stderr[-2000:]
