"""Results readers: the simulator's CSVs and benchmark grids, as tables
and figures.

A NumPy/matplotlib copy of polar_codes_tpu/tools/analysis.py. It reads
two formats:
- the pcsim-schema CSV (`<output>_<simtype>.csv`, 23 columns) that
  sim/montecarlo.py writes, in either package: load, merge runs, group
  into curves, plot BLER and FER/throughput;
- benchmark grids as JSON lines, one object per row with a `bench` name
  `family[_dtype]_nN[_lL][_variant]`, `N`, `K`, `code_thr_mbps`,
  `info_thr_mbps` and, for a row that failed, `error` (the format
  polar_codes_tpu/sim/benchmark.py writes): load, compare two grids,
  throughput over K or N.

CLI:

    python -m polar_codes_torch.tools.analysis overlay ours.csv ref.csv -o f.png
    python -m polar_codes_torch.tools.analysis fer-combo results.csv -o f.png
    python -m polar_codes_torch.tools.analysis grid-compare a.jsonl b.jsonl
    python -m polar_codes_torch.tools.analysis grid-throughput b.jsonl -o f.png
"""

from __future__ import annotations

import argparse
import csv
import json
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---- pcsim-schema CSV loading (analyze_results.py:load_pcs_csv_file) ----

def read_results_csv(path: str) -> List[Dict[str, float]]:
    """Parse a `<output>_<simtype>.csv` file into a list of row dicts."""
    rows = []
    with open(path) as f:
        reader = csv.DictReader(f)
        for raw in reader:
            rows.append(
                {k.strip('"'): _coerce(v) for k, v in raw.items() if k}
            )
    return rows


def _coerce(value):
    try:
        f = float(value)
        return int(f) if f.is_integer() and "e" not in value.lower() else f
    except (TypeError, ValueError):
        return value


def merge_results(row_lists: List[List[dict]]) -> List[dict]:
    """Merge rows from multiple runs: duplicate (N,K,L,C,Eb/N0) points are
    combined by re-deriving the rates from summed Runs/Errors (the
    merge_multi_entries averaging of analyze_results.py:79-86, done on
    counts so unequal run lengths weight correctly)."""
    merged: Dict[Tuple, dict] = {}
    for rows in row_lists:
        for r in rows:
            key = (r.get("N"), r.get("K"), r.get("L"), r.get("C"),
                   r.get("Eb/N0"))
            if key not in merged:
                merged[key] = dict(r)
                continue
            m = merged[key]
            runs = (m.get("Runs", 0) or 0) + (r.get("Runs", 0) or 0)
            errs = (m.get("Errors", 0) or 0) + (r.get("Errors", 0) or 0)
            if runs:
                for rate_key in ("BLER", "BER", "RER"):
                    a = float(m.get(rate_key, 0) or 0)
                    b = float(r.get(rate_key, 0) or 0)
                    wa = float(m.get("Runs", 0) or 0)
                    wb = float(r.get("Runs", 0) or 0)
                    m[rate_key] = (a * wa + b * wb) / runs
            m["Runs"], m["Errors"] = runs, errs
    return list(merged.values())


def summarize_results(
    rows: List[Dict[str, float]]
) -> Dict[Tuple, Dict[str, np.ndarray]]:
    """Group rows by (N, K, L, C) and return per-group sorted curves:
    {'ebn0': [...], 'bler': [...], 'ber': [...], 'throughput_mbps': [...]}.
    """
    groups = defaultdict(list)
    for r in rows:
        groups[(r.get("N"), r.get("K"), r.get("L"), r.get("C"))].append(r)
    out = {}
    for key, rws in groups.items():
        rws.sort(key=lambda r: r.get("Eb/N0", 0.0))
        out[key] = {
            "ebn0": np.array([r.get("Eb/N0", 0.0) for r in rws]),
            "bler": np.array([r.get("BLER", 0.0) for r in rws]),
            "ber": np.array([r.get("BER", 0.0) for r in rws]),
            "throughput_mbps": np.array(
                [r.get("Coded Bitrate", 0.0) / 1e6 for r in rws]
            ),
        }
    return out


# ---- figures (plot_fer_throughput_combo / plot_fer analogues) -----------

def _axes(figsize=(7, 5)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt.subplots(figsize=figsize)


def plot_bler_curves(rows, path: str = None):
    """BLER-vs-Eb/N0 semilog plot (analyze_results.py plot_fer)."""
    fig, ax = _axes()
    for key, c in sorted(summarize_results(rows).items()):
        n_len, k_len, l_size, crc = key
        ax.semilogy(
            c["ebn0"], np.maximum(c["bler"], 1e-99),
            marker="o", label=f"N={n_len} K={k_len} L={l_size} C={crc}",
        )
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BLER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_bler_overlay(rows_a, rows_b, labels=("ours", "reference"),
                      path: str = None):
    """Two result sets on one BLER figure (solid vs dashed), matched by
    (N, K, L, C) — the pcsim-vs-pcsim comparison workflow."""
    fig, ax = _axes()
    for rows, label, style in ((rows_a, labels[0], "-o"),
                               (rows_b, labels[1], "--s")):
        for key, c in sorted(summarize_results(rows).items()):
            n_len, k_len, l_size, crc = key
            ax.semilogy(
                c["ebn0"], np.maximum(c["bler"], 1e-99), style,
                label=f"{label}: N={n_len} K={k_len} L={l_size} C={crc}",
                alpha=0.85,
            )
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BLER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_fer_throughput_combo(rows, path: str = None):
    """Twin-axis FER + throughput over Eb/N0, one line pair per list size
    (analyze_results.py:plot_fer_throughput_combo)."""
    fig, ax0 = _axes()
    ax1 = ax0.twinx()
    for key, c in sorted(summarize_results(rows).items()):
        _, _, l_size, _ = key
        ax0.semilogy(c["ebn0"], np.maximum(c["bler"], 1e-99), "--",
                     label=f"L={l_size}")
        ax1.plot(c["ebn0"], c["throughput_mbps"], label=f"L={l_size}")
    ax0.set_xlabel(r"$E_b/N_0$ [dB]")
    ax0.set_ylabel("FER")
    ax1.set_ylabel("Throughput [Mbit/s]")
    ax0.grid(True, which="both", alpha=0.3)
    ax0.legend(fontsize=8, loc="lower left")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


# ---- benchmark grids (plot_polar_code_benchmark.py analogues) ----------

_NAME_RE = re.compile(
    r"^(?P<family>[a-z0-9_]+?)(?:_(?P<dtype>float|char|pallas|pallas_char))?"
    r"_n(?P<n>\d+)(?:_l(?P<l>\d+))?(?P<rest>(?:_[a-z0-9]+)*)$"
)


def parse_bench_name(name: str) -> dict:
    """Structured fields from a grid row name (the parse_benchmark_name
    analogue for our `family_dtype_nN_lL[_variant]` convention)."""
    m = _NAME_RE.match(name)
    if not m:
        return {"family": name}
    out = {"family": m.group("family"),
           "dtype": m.group("dtype") or "float",
           "N": int(m.group("n"))}
    if m.group("l"):
        out["L"] = int(m.group("l"))
    rest = (m.group("rest") or "").strip("_")
    if rest:
        out["variant"] = rest
    return out


def load_benchmark_jsonl(path: str) -> List[dict]:
    """Measured rows from a sim.benchmark JSON-lines artifact; when a row
    name appears multiple times the LAST measured entry wins (the
    append-on-resume convention), error rows are kept only if a row never
    succeeded (merge_results semantics of plot_polar_code_benchmark.py)."""
    by_name: Dict[str, dict] = {}
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            name = rec.get("bench")
            if not name:
                continue
            if "error" in rec and "error" not in by_name.get(name, rec):
                continue  # never overwrite a measurement with an error
            by_name[name] = rec
    rows = []
    for name, rec in by_name.items():
        rec = dict(rec)
        rec.update(parse_bench_name(name))
        rows.append(rec)
    return rows


def throughput_over_info_length(rows: List[dict], family: str,
                                dtype: str = "float") -> tuple:
    """(K array, CodeThr, InfoThr) sorted by K for one decoder family
    (plot_polar_code_benchmark.py:prepare_throughput_over_info_length)."""
    sel = [r for r in rows
           if r.get("family") == family and r.get("dtype") == dtype
           and "error" not in r]
    sel.sort(key=lambda r: r.get("K", 0))
    return (np.array([r["K"] for r in sel]),
            np.array([r.get("code_thr_mbps", 0.0) for r in sel]),
            np.array([r.get("info_thr_mbps", 0.0) for r in sel]))


def compare_grids(rows_a: List[dict], rows_b: List[dict]) -> List[dict]:
    """Row-matched throughput ratios b/a (the cross-file merge_results
    workflow): one record per bench name present in both."""
    a_by = {r["bench"]: r for r in rows_a if "error" not in r}
    out = []
    for r in rows_b:
        if "error" in r or r["bench"] not in a_by:
            continue
        a = a_by[r["bench"]]
        thr_a = a.get("info_thr_mbps", 0.0)
        thr_b = r.get("info_thr_mbps", 0.0)
        out.append(dict(
            bench=r["bench"],
            a_mbps=thr_a, b_mbps=thr_b,
            ratio=(thr_b / thr_a) if thr_a else float("nan"),
        ))
    out.sort(key=lambda d: d["ratio"])
    return out


def plot_grid_throughput(rows: List[dict], path: str = None):
    """Info-throughput over N per family/dtype from one grid artifact
    (the benchmark-suite summary figure)."""
    fig, ax = _axes(figsize=(8, 5))
    series = defaultdict(list)
    for r in rows:
        if "error" in r or "N" not in r:
            continue
        if r.get("variant"):
            continue  # keep the main sweep uncluttered
        key = (r["family"], r.get("dtype", "float"),
               r.get("L"))
        series[key].append((r["N"], r.get("info_thr_mbps", 0.0)))
    for (family, dtype, l_size), pts in sorted(series.items()):
        if len(pts) < 2:
            continue
        pts.sort()
        n, thr = zip(*pts)
        label = f"{family}/{dtype}" + (f" L={l_size}" if l_size else "")
        ax.loglog(n, thr, marker="o", label=label)
    ax.set_xlabel("block length N")
    ax.set_ylabel("info throughput [Mbit/s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


# ---- CLI ----------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(prog="polar-analysis", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ov = sub.add_parser("overlay", help="BLER overlay of two result CSVs")
    ov.add_argument("csv_a")
    ov.add_argument("csv_b")
    ov.add_argument("-o", "--output", default="bler_overlay.png")
    ov.add_argument("--labels", default="ours,reference")
    fc = sub.add_parser("fer-combo", help="FER+throughput combo figure")
    fc.add_argument("csv", nargs="+")
    fc.add_argument("-o", "--output", default="fer_combo.png")
    gc = sub.add_parser("grid-compare", help="throughput ratios of two "
                        "benchmark grid artifacts (b vs a)")
    gc.add_argument("jsonl_a")
    gc.add_argument("jsonl_b")
    gt = sub.add_parser("grid-throughput", help="throughput-over-N figure "
                        "from one grid artifact")
    gt.add_argument("jsonl")
    gt.add_argument("-o", "--output", default="grid_throughput.png")
    args = p.parse_args(argv)

    if args.cmd == "overlay":
        labels = tuple(args.labels.split(",", 1))
        plot_bler_overlay(read_results_csv(args.csv_a),
                          read_results_csv(args.csv_b),
                          labels=labels, path=args.output)
        print(f"wrote {args.output}")
    elif args.cmd == "fer-combo":
        rows = merge_results([read_results_csv(c) for c in args.csv])
        plot_fer_throughput_combo(rows, path=args.output)
        print(f"wrote {args.output}")
    elif args.cmd == "grid-compare":
        recs = compare_grids(load_benchmark_jsonl(args.jsonl_a),
                             load_benchmark_jsonl(args.jsonl_b))
        for r in recs:
            print(f"{r['bench']:40s} {r['a_mbps']:10.1f} -> "
                  f"{r['b_mbps']:10.1f} Mbit/s   x{r['ratio']:.2f}")
        if recs:
            ratios = np.array([r["ratio"] for r in recs])
            ratios = ratios[np.isfinite(ratios)]
            print(f"geomean x{np.exp(np.mean(np.log(ratios))):.2f} "
                  f"over {len(ratios)} shared rows")
    elif args.cmd == "grid-throughput":
        plot_grid_throughput(load_benchmark_jsonl(args.jsonl), args.output)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
