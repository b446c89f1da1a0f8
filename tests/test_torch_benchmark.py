"""The port's benchmark grid (polar_codes_torch/sim/benchmark.py) against
the JAX package's on the CPU: the rows are JAX's with the Pallas/XLA arm
mapped away, one per program; the names, the resume set and the batch
policy equal JAX's; the CLI runs rows on the CPU, resumes without running
any, records a failing row, and writes what the port's report reads."""

import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_tpu.sim import benchmark as jbench  # noqa: E402
from polar_codes_torch.sim import benchmark  # noqa: E402
from polar_codes_torch.tools import report  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX record's keys (polar_codes_tpu/sim/benchmark.py run_row) and the port's two
RECORD_KEYS = {"bench", "N", "K", "C", "L", "dtype", "batch", "platform",
               "seconds_per_batch", "code_thr_mbps", "info_thr_mbps", "blocks_per_s",
               "flops", "bytes_accessed", "cost_model", "device_name", "power_limit_w"}
CPU_ROWS = ["--platform", "cpu", "--quick", "--filter", "n256", "--batch-bits", "16384"]


def _mapped(jrow):
    """A JAX row under the port's rule: the arm's dtype mapped to the
    family; the Pallas cascl_scan rows' bf16 stage carry kept."""
    row = {k: v for k, v in jrow.items() if k != "bench"}
    if row["kind"] == "cascl_scan" and row["dtype"] == "pallas":
        row["carry"] = "bf16"
    row["dtype"] = {"pallas": "float", "pallas_char": "char"}.get(row["dtype"], row["dtype"])
    return row


@pytest.mark.parametrize("quick,n_rows,n_jax", [(True, 17, 24), (False, 126, 172)])
def test_rows_are_jax_rows_with_the_arm_mapped_away(quick, n_rows, n_jax):
    jrows = jbench.enumerate_rows(quick)
    rows = benchmark.enumerate_rows(quick)
    assert (len(rows), len(jrows)) == (n_rows, n_jax)
    want = []
    for jrow in jrows:
        row = _mapped(jrow)
        if row not in want:
            want.append(row)
    assert [{k: v for k, v in r.items() if k != "bench"} for r in rows] == want
    assert len({r["bench"] for r in rows}) == n_rows
    by_program = {json.dumps(_mapped(r), sort_keys=True) for r in jrows}
    assert by_program == {json.dumps({k: v for k, v in r.items() if k != "bench"},
                                     sort_keys=True) for r in rows}
    if not quick:  # JAX's XLA arm skipped these; the port runs them
        names = {r["bench"] for r in rows}
        assert {"cascl_float_n4096_l16", "cascl_float_n4096_l32",
                "cascl_scan_float_n32768_l8_carrybf16"} <= names
        assert not any(r["bench"].endswith("carrybf16") for r in jrows)


@pytest.mark.parametrize("quick", [True, False])
def test_row_name_equals_jax_on_every_jax_row(quick):
    for jrow in jbench.enumerate_rows(quick):
        assert benchmark.row_name(jrow) == jbench.row_name(jrow) == jrow["bench"]


def test_load_done_and_batch_policy_equal_jax(tmp_path):
    path = tmp_path / "grid.jsonl"
    lines = [json.dumps({"bench": "a", "seconds_per_batch": 1.0}),
             json.dumps({"bench": "b", "error": "RuntimeError: x"}),
             json.dumps({"bench": "c", "error": "E"}), json.dumps({"bench": "c", "error": "E"}),
             json.dumps({"bench": "d", "error": "E"}), json.dumps({"bench": "d"}),
             "not json {", json.dumps({"no_bench": 1}), ""]
    path.write_text("\n".join(lines))
    assert benchmark.load_done(str(path)) == jbench.load_done(str(path)) == {"a", "c", "d"}
    assert benchmark.load_done(str(tmp_path / "none")) == jbench.load_done(
        str(tmp_path / "none")) == set()
    for shift in range(5, 18):
        for budget in (1 << 14, 1 << 21, 1 << 24, 12345):
            assert (benchmark.bits_budget_batch(1 << shift, budget)
                    == jbench.bits_budget_batch(1 << shift, budget))
        assert benchmark.bits_budget_batch(1 << shift) == jbench.bits_budget_batch(1 << shift)


def test_cli_runs_resumes_and_the_report_reads_it(tmp_path, capsys):
    out = tmp_path / "grid.jsonl"
    assert benchmark.main(CPU_ROWS + ["-o", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    want = [r["bench"] for r in benchmark.enumerate_rows(True) if "n256" in r["bench"]]
    assert [r["bench"] for r in recs] == want and len(want) == 5
    for rec in recs:
        assert RECORD_KEYS <= set(rec) and "error" not in rec
        assert rec["platform"] == "cpu" and rec["cost_model"] == "analytic"
        assert rec["device_name"] is None and rec["power_limit_w"] is None
        assert "mfu" not in rec  # no peak on the CPU
        assert rec["seconds_per_batch"] > 0 and rec["batch"] == 64
        assert rec["code_thr_mbps"] == pytest.approx(64 * rec["N"] / rec["seconds_per_batch"] / 1e6)
    capsys.readouterr()
    assert benchmark.main(CPU_ROWS + ["-o", str(out)]) == 0  # the resume
    assert capsys.readouterr().out == ""
    assert len(out.read_text().splitlines()) == len(recs)
    html = tmp_path / "report.html"
    report.main([str(out), "-o", str(html)])
    capsys.readouterr()
    text = html.read_text()
    assert all(name in text for name in want)
    assert benchmark.main(CPU_ROWS + ["--list", "-o", str(out)]) == 0
    assert capsys.readouterr().out.split() == want


def test_a_failing_row_is_recorded_and_the_grid_goes_on(tmp_path, monkeypatch):
    out = tmp_path / "grid.jsonl"
    run_row = benchmark.run_row

    def failing(row, batch_bits, out, device):
        if row["bench"] == "encode_n256_crc32":
            raise ValueError("deterministic")
        return run_row(row, batch_bits, out, device)

    monkeypatch.setattr(benchmark, "run_row", failing)
    argv = ["--platform", "cpu", "--quick", "--filter", "encode_n256", "--batch-bits", "16384",
            "-o", str(out)]
    assert benchmark.main(argv) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["bench"], r.get("error")) for r in recs] == [
        ("encode_n256_crc0", None), ("encode_n256_crc32", "ValueError: deterministic"),
        ("encode_n256_crc16", None)]
    benchmark.main(argv)  # one retry; a second failure marks it done
    assert benchmark.load_done(str(out)) == {r["bench"] for r in recs}


def test_auto_platform_needs_a_card_and_loop_resumes_in_a_child(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --platform auto runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--quick", "--filter", "encode_n256_crc0", "-o",
                        str(tmp_path / "x.jsonl")])
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "loop.jsonl"
    argv = ["--loop", "--platform", "cpu", "--quick", "--filter", "encode_n256_crc0",
            "--batch-bits", "16384", "-o", str(out)]
    assert benchmark.main(argv) == 0
    assert benchmark.load_done(str(out)) == {"encode_n256_crc0"}
