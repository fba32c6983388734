"""Zero-dependency operator dashboard: one HTML file, or plain text.

A copy of `repro.obs.dashboard` for the port.

Everything the obs stack produces — frontier rows, SLO burn rates,
straggler blame, the decision timeline, quantile sketches — rendered into
a single self-contained HTML file (inline CSS, inline SVG sparklines, no
external assets, no JS frameworks) so a bench artifact or CI upload is
viewable anywhere a browser opens a file.  `render_text` is the same
report for terminals.

All sections are optional; pass what you have::

    html = render_dashboard(
        title="fleet run",
        frontier=rows,                    # fleet.vector.frontier rows
        slo=server.slo_report(),          # FleetHedgedServer
        blame=blame.summary(),            # obs.blame.StragglerBlame
        decisions=controller.decisions,   # obs.decisions.DecisionLog
        sketches={"sojourn": sk},         # name -> QuantileSketch
        registry=server.metrics,          # obs.registry.MetricsRegistry
    )
    write_dashboard("report.html", frontier=rows, ...)
"""

from __future__ import annotations

import html as _html
from pathlib import Path
from typing import Optional

__all__ = ["render_dashboard", "write_dashboard", "render_text"]

_CSS = """
body { font: 14px/1.5 -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2rem auto; max-width: 72rem; padding: 0 1rem;
       color: #1a2233; background: #fbfbfd; }
h1 { font-size: 1.4rem; border-bottom: 2px solid #d7dbe4; padding-bottom: .4rem; }
h2 { font-size: 1.05rem; margin-top: 2rem; color: #30415d; }
table { border-collapse: collapse; width: 100%; font-size: 13px;
        font-variant-numeric: tabular-nums; }
th, td { text-align: right; padding: 3px 10px; border-bottom: 1px solid #e8eaf0; }
th { color: #5a6478; font-weight: 600; background: #f1f3f7; }
td:first-child, th:first-child { text-align: left; }
.bar { display: inline-block; height: 9px; border-radius: 2px;
       background: #7a93c4; vertical-align: baseline; }
.ok   { color: #1e7d43; } .warn { color: #b07a18; } .bad  { color: #b0321e; }
.mono { font-family: ui-monospace, Menlo, monospace; font-size: 12px; }
.note { color: #6b7385; font-size: 12px; }
svg { vertical-align: middle; }
"""

_BURN_WARN, _BURN_BAD = 1.0, 6.0


def _esc(x) -> str:
    return _html.escape(str(x))


def _num(x, nd: int = 3) -> str:
    if isinstance(x, bool):
        return "yes" if x else "no"
    if isinstance(x, float):
        if x != x:
            return "–"
        if x and (abs(x) >= 1e5 or abs(x) < 10 ** -nd):
            return f"{x:.2e}"
        return f"{x:.{nd}f}".rstrip("0").rstrip(".")
    return _esc(x)


def _table(headers, rows) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>" for r in rows
    )
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def _burn_cell(rate: float) -> str:
    cls = "ok" if rate < _BURN_WARN else ("warn" if rate < _BURN_BAD else "bad")
    w = min(120, max(2, int(rate * 24)))
    return (f'<span class="{cls}">{_num(rate, 2)}</span> '
            f'<span class="bar" style="width:{w}px"></span>')


def _sparkline(sketch, width: int = 160, height: int = 28) -> str:
    """Inline SVG of the sketch's bucket mass over log-value space — the
    shape of the distribution, tail to the right."""
    items = sorted(sketch._store.items())
    if not items:
        return '<span class="note">empty</span>'
    keys = [k for k, _ in items]
    k_lo, k_hi = keys[0], keys[-1]
    span = max(1, k_hi - k_lo)
    import math

    c_max = max(math.log1p(c) for _, c in items)
    pts = []
    for k, c in items:
        x = (k - k_lo) / span * (width - 2) + 1
        y = height - 1 - math.log1p(c) / c_max * (height - 6)
        pts.append(f"{x:.1f},{y:.1f}")
    poly = " ".join(pts)
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline points="{poly}" fill="none" stroke="#4a6fa5" '
            f'stroke-width="1.5"/></svg>')


def _section_frontier(rows) -> str:
    cols = ["policy", "lam", "mean_sojourn", "p99", "p999", "evt_p999",
            "evt_p9999", "evt_xi", "rho", "mean_cost"]
    cols = [c for c in cols if any(c in r for r in rows)]
    body = [[_num(r.get(c, float("nan"))) if c != "policy"
             else f'<span class="mono">{_esc(r.get(c, ""))}</span>'
             for c in cols] for r in rows]
    return "<h2>Frontier</h2>" + _table(cols, body)


def _section_slo(slo: dict) -> str:
    out = ["<h2>SLO burn rates</h2>"]
    rows = []
    for pri, rep in sorted(slo.items()):
        burns = rep.get("burn_rates", {})
        for w, rate in burns.items():
            rows.append([
                _esc(pri), _esc(rep.get("slo", "")),
                _num(rep.get("threshold", float("nan"))),
                _esc(w), _burn_cell(float(rate)),
                _num(rep.get("budget_remaining", float("nan")), 2),
                _num(bool(rep.get("burning", False))),
            ])
    out.append(_table(
        ["priority", "slo", "threshold", "window", "burn rate",
         "budget left", "burning"], rows))
    out.append('<p class="note">burn &lt; 1: inside budget; '
               'sustained burn &gt; 1 on every window exhausts the error '
               'budget early.</p>')
    return "".join(out)


def _section_blame(blame: dict) -> str:
    ranking = blame.get("ranking", [])
    rows = []
    for i, s in enumerate(ranking):
        w = min(160, max(2, int(s["score"] * 320)))
        rows.append([
            f"#{i + 1}", _esc(s["name"]), s["n"], _num(s["mean"]),
            _num(s["p_q"]), _num(s["share"], 2), _num(s["tail_delta"]),
            f'{_num(s["score"], 3)} <span class="bar" '
            f'style="width:{w}px;background:#c0604a"></span>',
            _num(s.get("ks", float("nan")), 2),
        ])
    drifted = blame.get("drifted", {})
    note = ""
    if drifted:
        note = ('<p class="note">drifting: ' + ", ".join(
            f"{_esc(n)} (KS {_num(v, 2)}×)" for n, v in drifted.items())
            + "</p>")
    return ("<h2>Straggler blame</h2>" + _table(
        ["rank", "machine", "jobs", "mean", f"p{100 * blame.get('quantile', 0.99):g}",
         "share", "tail Δ", "blame score", "drift"], rows) + note)


def _section_decisions(decisions) -> str:
    events = list(decisions)
    rows = []
    for e in events[-60:]:
        rows.append([
            _num(float(e.t), 2), _esc(e.kind),
            f'<span class="mono">{_esc(e.label)}</span>', _esc(e.trigger),
            _num(float(e.lam_hat)), _num(float(e.rho)),
            _num(float(e.ks_stat)), e.n_vetoed or "",
        ])
    extra = ("" if len(events) <= 60 else
             f'<p class="note">last 60 of {len(events)} events</p>')
    return ("<h2>Decision timeline</h2>" + _table(
        ["t", "kind", "label", "trigger", "λ̂", "ρ", "ks", "vetoed"], rows)
        + extra)


def _section_sketches(sketches: dict) -> str:
    rows = []
    for name, sk in sketches.items():
        p50, p99, p999 = sk.quantiles((0.5, 0.99, 0.999))
        rows.append([
            _esc(name), _sparkline(sk), int(sk.count), _num(sk.mean),
            _num(p50), _num(p99), _num(p999),
        ])
    return "<h2>Latency sketches</h2>" + _table(
        ["stream", "shape (log-log)", "count", "mean", "p50", "p99",
         "p999"], rows)


def _section_registry(registry) -> str:
    rows = []
    for key, snap in list(registry.collect().items())[:80]:
        if snap["type"] == "histogram":
            val = (f"count={_num(float(snap['count']))} "
                   f"p99={_num(float(snap['p99']))} "
                   f"p999={_num(float(snap['p999']))}")
        else:
            val = _num(float(snap["value"]))
        rows.append([f'<span class="mono">{_esc(key)}</span>',
                     _esc(snap["type"]), val])
    return "<h2>Metrics</h2>" + _table(["metric", "type", "value"], rows)


def render_dashboard(
    *,
    title: str = "Tail observatory",
    frontier=None,
    slo: Optional[dict] = None,
    blame: Optional[dict] = None,
    decisions=None,
    sketches: Optional[dict] = None,
    registry=None,
) -> str:
    """Assemble the single-file HTML report from whatever is provided."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
    ]
    if frontier:
        parts.append(_section_frontier(list(frontier)))
    if slo:
        parts.append(_section_slo(slo))
    if blame:
        parts.append(_section_blame(blame))
    if sketches:
        parts.append(_section_sketches(sketches))
    if decisions is not None and len(decisions):
        parts.append(_section_decisions(decisions))
    if registry is not None:
        parts.append(_section_registry(registry))
    parts.append("</body></html>")
    return "".join(parts)


def write_dashboard(path, **kwargs) -> Path:
    """Render and write; returns the path."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(render_dashboard(**kwargs))
    return p


# --------------------------------------------------------------------------
# terminal renderer
# --------------------------------------------------------------------------


def _txt_table(headers, rows) -> str:
    cells = [[str(h) for h in headers]] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    lines = []
    for j, r in enumerate(cells):
        lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_text(
    *,
    title: str = "Tail observatory",
    frontier=None,
    slo: Optional[dict] = None,
    blame: Optional[dict] = None,
    decisions=None,
    sketches: Optional[dict] = None,
    registry=None,
) -> str:
    """The same report as plain text (bench logs, terminals)."""
    out = [title, "=" * len(title)]
    if frontier:
        cols = ["policy", "lam", "mean_sojourn", "p99", "p999", "evt_p999",
                "evt_xi", "rho"]
        cols = [c for c in cols if any(c in r for r in frontier)]
        out += ["", "frontier:", _txt_table(
            cols, [[_num(r.get(c, float("nan"))) for c in cols]
                   for r in frontier])]
    if slo:
        rows = []
        for pri, rep in sorted(slo.items()):
            for w, rate in rep.get("burn_rates", {}).items():
                mark = ("!!" if rate >= _BURN_BAD
                        else "!" if rate >= _BURN_WARN else "")
                rows.append([pri, rep.get("slo", ""), w, _num(rate, 2), mark])
        out += ["", "slo burn rates:",
                _txt_table(["pri", "slo", "window", "burn", ""], rows)]
    if blame:
        rows = [[f"#{i + 1}", s["name"], s["n"], _num(s["mean"]),
                 _num(s["tail_delta"]), _num(s["score"], 3),
                 "#" * min(40, int(s["score"] * 80))]
                for i, s in enumerate(blame.get("ranking", []))]
        out += ["", "straggler blame:",
                _txt_table(["rank", "machine", "jobs", "mean", "tailΔ",
                            "score", ""], rows)]
    if sketches:
        rows = []
        for name, sk in sketches.items():
            p50, p99, p999 = sk.quantiles((0.5, 0.99, 0.999))
            rows.append([name, int(sk.count), _num(sk.mean), _num(p50),
                         _num(p99), _num(p999)])
        out += ["", "sketches:", _txt_table(
            ["stream", "count", "mean", "p50", "p99", "p999"], rows)]
    if decisions is not None and len(decisions):
        out += ["", "decisions:", decisions.render()]
    if registry is not None:
        out += ["", "metrics:", registry.render()]
    return "\n".join(out)
