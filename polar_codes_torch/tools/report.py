"""Standalone HTML sweep report.

A copy of polar_codes_tpu/tools/report.py: one self-contained HTML file
(no external assets, light and dark aware) with a KPI row, BLER/BER
waterfall charts (SVG, hover crosshair and tooltip), a throughput chart per
benchmark family and tables of every input row. It has no timestamp, so
the same inputs and title give the same file.

    python -m polar_codes_torch.tools.report results_single.csv grid.jsonl \
        -o report.html

Inputs: any mix of pcsim-schema CSV files (sim/montecarlo.py output) and
benchmark JSON-lines files (the format tools/analysis.py reads); the type
is sniffed from the first line.
"""

from __future__ import annotations

import argparse
import html
import json
import math
import os
from typing import Dict, List, Sequence

from .analysis import read_results_csv, summarize_results

DEFAULT_TITLE = "polar_codes_torch sweep report"

# Categorical palette (validated reference instance, fixed slot order —
# identity is carried by legend + table as well, never color alone).
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767"]
_MAX_SERIES = 8  # token ceiling: past it, curves fold into the table view

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: #f9f9f7; color: #0b0b0b;
}
.card {
  background: #fcfcfb; border: 1px solid rgba(11,11,11,0.10);
  border-radius: 8px; padding: 16px 20px; margin-bottom: 20px;
}
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 0 0 12px; font-weight: 600; }
.sub { color: #52514e; font-size: 12px; margin-bottom: 20px; }
.kpis { display: flex; gap: 16px; flex-wrap: wrap; margin-bottom: 20px; }
.tile {
  background: #fcfcfb; border: 1px solid rgba(11,11,11,0.10);
  border-radius: 8px; padding: 12px 18px; min-width: 150px;
}
.tile .label { font-size: 12px; color: #52514e; }
.tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
.tile .note { font-size: 11px; color: #898781; margin-top: 2px; }
svg text { font-family: inherit; }
.axis-label { font-size: 11px; fill: #898781; }
.tick { font-size: 10px; fill: #898781; }
.grid { stroke: #e1e0d9; stroke-width: 1; }
.baseline { stroke: #c3c2b7; stroke-width: 1; }
.legend { display: flex; gap: 14px; flex-wrap: wrap; margin-top: 8px;
          font-size: 12px; color: #52514e; }
.legend .key { display: inline-block; width: 14px; height: 3px;
               vertical-align: middle; margin-right: 5px; border-radius: 2px; }
table { border-collapse: collapse; font-size: 12px; width: 100%; }
th, td { padding: 4px 10px; text-align: right;
         border-bottom: 1px solid #e1e0d9;
         font-variant-numeric: tabular-nums; }
th { color: #52514e; font-weight: 600; }
td:first-child, th:first-child { text-align: left; }
details > summary { cursor: pointer; font-size: 13px; color: #52514e;
                    margin-bottom: 8px; }
.tooltip {
  position: fixed; pointer-events: none; display: none; z-index: 10;
  background: #fcfcfb; border: 1px solid rgba(11,11,11,0.2);
  border-radius: 6px; padding: 6px 10px; font-size: 12px;
  box-shadow: 0 2px 8px rgba(11,11,11,0.12);
}
.tooltip .trow { display: flex; align-items: center; gap: 6px; }
.tooltip .tkey { display: inline-block; width: 12px; height: 3px;
                 border-radius: 2px; }
.tooltip .tval { font-weight: 600; }
.tooltip .tname { color: #52514e; }
@media (prefers-color-scheme: dark) {
  body { background: #0d0d0d; color: #ffffff; }
  .card, .tile, .tooltip { background: #1a1a19;
                           border-color: rgba(255,255,255,0.10); }
  .sub, .tile .label, .legend, th, details > summary,
  .tooltip .tname { color: #c3c2b7; }
  .grid { stroke: #2c2c2a; }
  .baseline { stroke: #383835; }
  th, td { border-bottom-color: #2c2c2a; }
}
"""

_JS = """
document.querySelectorAll('[data-chart]').forEach(function (svg) {
  var tip = document.getElementById('tooltip');
  var data = JSON.parse(svg.getAttribute('data-chart'));
  var hair = svg.querySelector('.crosshair');
  svg.addEventListener('pointermove', function (ev) {
    var pt = svg.createSVGPoint();
    pt.x = ev.clientX; pt.y = ev.clientY;
    var loc = pt.matrixTransform(svg.getScreenCTM().inverse());
    var best = 0, bd = Infinity;
    data.xs.forEach(function (x, i) {
      var d = Math.abs(x - loc.x);
      if (d < bd) { bd = d; best = i; }
    });
    if (hair) {
      hair.setAttribute('x1', data.xs[best]);
      hair.setAttribute('x2', data.xs[best]);
      hair.style.display = 'block';
    }
    while (tip.firstChild) tip.removeChild(tip.firstChild);
    var head = document.createElement('div');
    head.appendChild(document.createTextNode(data.xlabels[best]));
    head.className = 'tname';
    tip.appendChild(head);
    data.series.forEach(function (s) {
      var v = s.values[best];
      if (v === null || v === undefined) return;
      var row = document.createElement('div'); row.className = 'trow';
      var key = document.createElement('span'); key.className = 'tkey';
      key.style.background = s.color;
      var val = document.createElement('span'); val.className = 'tval';
      val.appendChild(document.createTextNode(v));
      var name = document.createElement('span'); name.className = 'tname';
      name.appendChild(document.createTextNode(s.name));
      row.appendChild(key); row.appendChild(val); row.appendChild(name);
      tip.appendChild(row);
    });
    tip.style.display = 'block';
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 14) + 'px';
  });
  svg.addEventListener('pointerleave', function () {
    tip.style.display = 'none';
    if (hair) hair.style.display = 'none';
  });
});
"""


def _is_jsonl(path: str) -> bool:
    with open(path) as fh:
        first = fh.readline().strip()
    return first.startswith("{")


def _fmt(v, digits=3):
    if v is None:
        return ""
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.2e}"
        return f"{v:.{digits}g}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


# ---- SVG primitives ---------------------------------------------------------

_W, _H = 640, 320
_ML, _MR, _MT, _MB = 56, 16, 12, 36


def _xmap(x, x0, x1):
    span = (x1 - x0) or 1.0
    return _ML + (x - x0) / span * (_W - _ML - _MR)


def _ymap_log(y, lo_exp, hi_exp):
    y = max(y, 10.0 ** lo_exp)
    t = (math.log10(y) - lo_exp) / ((hi_exp - lo_exp) or 1)
    return _H - _MB - t * (_H - _MT - _MB)


def _line_chart_log(curves, ylabel, value_fmt):
    """Multi-series semilog-y line chart -> (svg_html, legend_html).

    curves: list of (name, xs, ys) with ys on a log scale (BLER/BER)."""
    pts = [y for _, _, ys in curves for y in ys if y > 0]
    if not pts:
        return "", ""
    lo_exp = math.floor(math.log10(max(min(pts), 1e-12)))
    hi_exp = math.ceil(math.log10(max(max(pts), 10.0 ** (lo_exp + 1))))
    xs_all = [x for _, xs, _ in curves for x in xs]
    x0, x1 = min(xs_all), max(xs_all)
    grid_xs = sorted({round(x, 6) for _, xs, _ in curves for x in xs})

    parts = [
        f'<svg viewBox="0 0 {_W} {_H}" role="img" '
        f'style="width:100%;max-width:{_W}px" '
    ]
    chart_meta = {
        "xs": [round(_xmap(x, x0, x1), 1) for x in grid_xs],
        "xlabels": [f"{x:g} dB" for x in grid_xs],
        "series": [],
    }
    body = []
    # hairline grid: one per decade + per x point
    for e in range(lo_exp, hi_exp + 1):
        y = _ymap_log(10.0 ** e, lo_exp, hi_exp)
        body.append(
            f'<line class="grid" x1="{_ML}" y1="{y:.1f}" '
            f'x2="{_W - _MR}" y2="{y:.1f}"/>'
            f'<text class="tick" x="{_ML - 6}" y="{y + 3:.1f}" '
            f'text-anchor="end">1e{e}</text>'
        )
    for x in grid_xs:
        px = _xmap(x, x0, x1)
        body.append(
            f'<text class="tick" x="{px:.1f}" y="{_H - _MB + 14}" '
            f'text-anchor="middle">{x:g}</text>'
        )
    body.append(
        f'<line class="baseline" x1="{_ML}" y1="{_H - _MB}" '
        f'x2="{_W - _MR}" y2="{_H - _MB}"/>'
        f'<text class="axis-label" x="{(_ML + _W - _MR) / 2:.0f}" '
        f'y="{_H - 6}" text-anchor="middle">Eb/N0 [dB]</text>'
        f'<text class="axis-label" transform="rotate(-90)" '
        f'x="{-_H / 2:.0f}" y="14" text-anchor="middle">'
        f'{html.escape(ylabel)}</text>'
    )
    legend = []
    for i, (name, xs, ys) in enumerate(curves):
        light = _SERIES_LIGHT[i % len(_SERIES_LIGHT)]
        pts_xy = [
            (_xmap(x, x0, x1), _ymap_log(y, lo_exp, hi_exp))
            for x, y in zip(xs, ys) if y > 0
        ]
        if not pts_xy:
            continue
        d = "M" + " L".join(f"{px:.1f},{py:.1f}" for px, py in pts_xy)
        body.append(
            f'<path d="{d}" fill="none" stroke="{light}" stroke-width="2" '
            f'stroke-linejoin="round" stroke-linecap="round"/>'
        )
        for px, py in pts_xy:
            body.append(
                f'<circle cx="{px:.1f}" cy="{py:.1f}" r="4" fill="{light}" '
                f'stroke="#fcfcfb" stroke-width="2"/>'
            )
        by_x = dict(zip(xs, ys))
        chart_meta["series"].append({
            "name": name,
            "color": light,
            "values": [
                value_fmt(by_x[x]) if x in by_x and by_x[x] > 0 else None
                for x in grid_xs
            ],
        })
        legend.append(
            f'<span><span class="key" style="background:{light}"></span>'
            f"{html.escape(name)}</span>"
        )
    body.append(
        f'<line class="crosshair grid" style="display:none" '
        f'y1="{_MT}" y2="{_H - _MB}" x1="0" x2="0"/>'
    )
    parts.append(
        "data-chart='" + html.escape(json.dumps(chart_meta), quote=True)
        + "'>"
    )
    parts.extend(body)
    parts.append("</svg>")
    legend_html = (
        f'<div class="legend">{"".join(legend)}</div>' if len(curves) > 1
        else ""
    )
    return "".join(parts), legend_html


def _bar_chart(rows, title_unit):
    """Horizontal bar chart of (label, value) magnitude comparison.

    One measure -> sequential job -> a single hue; value labels at bar tips
    (so every mark is labeled and the light-hue contrast relief holds)."""
    if not rows:
        return ""
    vmax = max(v for _, v in rows) or 1.0
    bar_h, gap = 22, 8
    height = _MT + len(rows) * (bar_h + gap) + 24
    label_w = 210
    parts = [
        f'<svg viewBox="0 0 {_W} {height}" role="img" '
        f'style="width:100%;max-width:{_W}px">'
    ]
    for i, (label, v) in enumerate(rows):
        y = _MT + i * (bar_h + gap)
        w = max((v / vmax) * (_W - label_w - 90), 1.5)
        parts.append(
            f'<text class="tick" x="{label_w - 8}" y="{y + bar_h / 2 + 3}" '
            f'text-anchor="end">{html.escape(label)}</text>'
            f'<path d="M{label_w},{y} H{label_w + w - 4:.1f} '
            f'a4,4 0 0 1 4,4 v{bar_h - 8} a4,4 0 0 1 -4,4 '
            f'H{label_w} Z" fill="#2a78d6"><title>{html.escape(label)}: '
            f"{_fmt(v)} {html.escape(title_unit)}</title></path>"
            f'<text class="tick" x="{label_w + w + 6:.1f}" '
            f'y="{y + bar_h / 2 + 3}">{_fmt(v)}</text>'
        )
    base_y = _MT + len(rows) * (bar_h + gap)
    parts.append(
        f'<line class="baseline" x1="{label_w}" y1="{_MT - 4}" '
        f'x2="{label_w}" y2="{base_y}"/>'
        f'<text class="axis-label" x="{label_w}" y="{base_y + 16}">'
        f"{html.escape(title_unit)}</text></svg>"
    )
    return "".join(parts)


def _table(headers: Sequence[str], rows: List[Sequence]) -> str:
    out = ["<table><tr>"]
    out.extend(f"<th>{html.escape(str(h))}</th>" for h in headers)
    out.append("</tr>")
    for r in rows:
        out.append("<tr>")
        out.extend(f"<td>{html.escape(_fmt(v))}</td>" for v in r)
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _tile(label: str, value: str, note: str = "") -> str:
    note_html = f'<div class="note">{html.escape(note)}</div>' if note else ""
    return (
        f'<div class="tile"><div class="label">{html.escape(label)}</div>'
        f'<div class="value">{html.escape(value)}</div>{note_html}</div>'
    )


# ---- report assembly --------------------------------------------------------


def _curve_section(csv_paths: List[str]) -> (str, List[str]):
    sections, tiles = [], []
    for path in csv_paths:
        rows = read_results_csv(path)
        if not rows:
            continue
        groups = summarize_results(rows)
        curves_bler, curves_ber = [], []
        for key in sorted(groups, key=str):
            n_len, k_len, l_size, crc = key
            name = f"N={n_len} K={k_len} L={l_size} C={crc}"
            c = groups[key]
            curves_bler.append((name, list(c["ebn0"]), list(c["bler"])))
            curves_ber.append((name, list(c["ebn0"]), list(c["ber"])))
        folded = ""
        if len(curves_bler) > _MAX_SERIES:
            folded = (
                f'<div class="sub">{len(curves_bler) - _MAX_SERIES} further '
                f"configurations are in the table below (series capped at "
                f"{_MAX_SERIES} for legibility).</div>"
            )
            curves_bler = curves_bler[:_MAX_SERIES]
            curves_ber = curves_ber[:_MAX_SERIES]
        fmt = lambda v: f"{v:.3g}"
        svg_bler, leg = _line_chart_log(curves_bler, "BLER", fmt)
        svg_ber, _ = _line_chart_log(curves_ber, "BER", fmt)
        headers = ["N", "K", "L", "C", "Eb/N0", "BLER", "BER", "Runs",
                   "Errors"]
        table_rows = [
            [r.get("N"), r.get("K"), r.get("L"), r.get("C"),
             r.get("Eb/N0"), r.get("BLER"), r.get("BER"), r.get("Runs"),
             r.get("Errors")]
            for r in rows
        ]
        sections.append(
            f'<div class="card"><h2>BLER — {html.escape(os.path.basename(path))}'
            f"</h2>{folded}{svg_bler}{leg}</div>"
            f'<div class="card"><h2>BER</h2>{svg_ber}{leg}</div>'
            f'<div class="card"><details><summary>All rows '
            f"({len(rows)})</summary>{_table(headers, table_rows)}"
            f"</details></div>"
        )
        best = min(rows, key=lambda r: r.get("BLER", 1.0))
        tiles.append(_tile(
            "Best BLER point",
            _fmt(best.get("BLER", 0.0)),
            f"N={best.get('N')} L={best.get('L')} @ "
            f"{best.get('Eb/N0')} dB",
        ))
    return "".join(sections), tiles


_FAMILY_LABELS = {
    "encode": "Encoder",
    "fastssc": "Fast-SSC decode",
    "cascl": "CA-SCL decode",
    "scan": "SCAN decode",
    "sc_scan": "SC decode (scan-over-schedule)",
    "cascl_scan": "CA-SCL decode (scan-over-schedule)",
}


def _bench_section(jsonl_paths: List[str]) -> (str, List[str]):
    rows = []
    for path in jsonl_paths:
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "bench" in rec and "error" not in rec:
                    rows.append(rec)
    if not rows:
        return "", []
    families: Dict[str, List[dict]] = {}
    for rec in rows:
        fam = rec["bench"].split("_")[0]
        if rec["bench"].startswith("sc_scan"):
            fam = "sc_scan"
        elif rec["bench"].startswith("cascl_scan"):
            fam = "cascl_scan"
        families.setdefault(fam, []).append(rec)
    sections, tiles = [], []
    cascl = [r for r in rows if r["bench"].startswith("cascl_float")]
    if cascl:
        flagship = max(cascl, key=lambda r: r["info_thr_mbps"])
        tiles.append(_tile(
            "CA-SCL peak info throughput",
            f"{flagship['info_thr_mbps']:,.0f} Mbit/s",
            flagship["bench"],
        ))
    enc = [r for r in rows if r["bench"].startswith("encode")]
    if enc:
        best = max(enc, key=lambda r: r["code_thr_mbps"])
        tiles.append(_tile(
            "Encoder peak throughput",
            f"{best['code_thr_mbps'] / 1e3:,.1f} Gbit/s",
            best["bench"],
        ))
    tiles.append(_tile("Benchmark rows", str(len(rows))))
    for fam in ("encode", "fastssc", "cascl", "scan", "sc_scan",
                "cascl_scan"):
        recs = families.get(fam)
        if not recs:
            continue
        recs = sorted(recs, key=lambda r: (r["N"], r.get("L", 0),
                                           r.get("dtype", "")))
        bars = [
            (r["bench"], r["code_thr_mbps"]) for r in recs
        ]
        sections.append(
            f'<div class="card"><h2>{_FAMILY_LABELS.get(fam, fam)} — coded '
            f"throughput</h2>{_bar_chart(bars, 'Mbit/s')}</div>"
        )
    headers = ["bench", "N", "K", "L", "dtype", "batch",
               "ms/batch", "coded Mbit/s", "info Mbit/s", "bound"]
    table_rows = [
        [r["bench"], r["N"], r["K"], r.get("L"), r.get("dtype"),
         r.get("batch"), round(r["seconds_per_batch"] * 1e3, 4),
         round(r["code_thr_mbps"], 1), round(r["info_thr_mbps"], 1),
         r.get("bound", "")]
        for r in rows
    ]
    sections.append(
        f'<div class="card"><details><summary>All benchmark rows '
        f"({len(rows)})</summary>{_table(headers, table_rows)}"
        f"</details></div>"
    )
    return "".join(sections), tiles


def render_report(paths: Sequence[str], out: str,
                  title: str = DEFAULT_TITLE) -> str:
    csvs = [p for p in paths if not _is_jsonl(p)]
    jsonls = [p for p in paths if _is_jsonl(p)]
    curve_html, curve_tiles = _curve_section(csvs)
    bench_html, bench_tiles = _bench_section(jsonls)
    tiles = "".join(bench_tiles + curve_tiles)
    doc = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        f"<style>{_CSS}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>"
        f'<div class="sub">{html.escape(", ".join(os.path.basename(p) for p in paths))}</div>'
        f'<div class="kpis">{tiles}</div>'
        f"{bench_html}{curve_html}"
        '<div id="tooltip" class="tooltip"></div>'
        f"<script>{_JS}</script></body></html>"
    )
    with open(out, "w") as fh:
        fh.write(doc)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="polar-report", description=__doc__)
    p.add_argument("inputs", nargs="+",
                   help="pcsim-schema CSVs and/or benchmark JSONL files")
    p.add_argument("-o", "--output", default="report.html")
    p.add_argument("--title", default=DEFAULT_TITLE)
    args = p.parse_args(argv)
    out = render_report(args.inputs, args.output, args.title)
    print(f"report written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
