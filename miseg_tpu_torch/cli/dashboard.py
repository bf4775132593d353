"""`dashboard` — a hyper-parameter study's report and web page from its
journal (counterpart of `miseg_tpu/cli/dashboard.py`; the reference's
`utils/run_server.py:6-27` serves optuna-dashboard on its journal).

    python -m miseg_tpu_torch.cli.dashboard \
        --storage experiments/MI-Seg.journal.jsonl --study_name swin --port 8080

Without `--port` it prints the JSON report (`study_report`) once; with
it, a stdlib HTTP server answers `/api/report` with that JSON and every
other path with a single page that draws the study's KPIs, its
optimisation history, each trial's intermediate values and the trials
table from `/api/report`, refreshing every 10 s while the study runs.
The report of a journal equals the JAX package's.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

from ..hpo import create_study


def study_report(storage: str, study_name: str = "study") -> dict:
    """The study in `storage` as JSON: direction, trials (state, value,
    params, intermediate values as reported) and the best trial."""
    # direction is adopted from the journal's persisted study record
    study = create_study(study_name=study_name, storage=storage, load_if_exists=True)
    # Trial.intermediate holds pruner-normalized values (sign-flipped for
    # minimize studies) — undo that for display
    sign = 1.0 if study.direction == "maximize" else -1.0
    trials = [{
        "number": t.number, "state": t.state, "value": t.value,
        "params": t.params,
        "reported": len(t.intermediate),
        "intermediate": sorted((int(s), sign * float(v))
                               for s, v in t.intermediate.items()),
    } for t in study.trials]
    best = study.best_trial
    return {"study": study_name, "direction": study.direction,
            "n_trials": len(trials),
            "best": ({"number": best.number, "value": best.value,
                      "params": best.params} if best else None),
            "trials": trials}


# Single-page UI.  Charts follow the house data-viz method: stat-tile KPI
# row (not one-bar charts); optimization history = dots + running-best line
# (two series -> legend, slots 1/2); intermediate curves use the EMPHASIS
# form (best trial in the accent hue, the rest in de-emphasis gray — trial
# identity is in the tooltip, not a 40-hue legend); palette slots are CSS
# custom properties with selected dark-mode steps; hover tooltips on every
# mark; the trials table is the always-available table view.
_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>miseg_tpu_torch study</title>
<style>
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px; font: 14px/1.45 system-ui, sans-serif;
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2df;
  --series-1: #2a78d6; --series-2: #eb6834; --muted-series: #c7c5c0;
  background: var(--surface-1); color: var(--text-primary);
}
@media (prefers-color-scheme: dark) {
  body {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #262625;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #3a3a38;
    --series-1: #3987e5; --series-2: #d95926; --muted-series: #55544f;
  }
}
h1 { font-size: 18px; margin: 0 0 4px; }
.sub { color: var(--text-secondary); margin-bottom: 20px; }
.kpis { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 24px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 12px 18px;
        min-width: 110px; }
.tile .v { font-size: 26px; font-weight: 600; }
.tile .l { color: var(--text-secondary); font-size: 12px; }
.charts { display: flex; gap: 24px; flex-wrap: wrap; margin-bottom: 24px; }
.chart { background: var(--surface-2); border-radius: 8px; padding: 14px; }
.chart h2 { font-size: 13px; margin: 0 0 2px; }
.chart .legend { font-size: 12px; color: var(--text-secondary);
                 margin-bottom: 6px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 2px; vertical-align: -1px; margin: 0 4px 0 10px; }
svg text { fill: var(--text-secondary); font-size: 10px; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: 5px 10px; font-size: 13px; }
th { color: var(--text-secondary); font-weight: 500;
     border-bottom: 1px solid var(--grid); }
tr:nth-child(even) td { background: var(--surface-2); }
td.best { font-weight: 600; }
#tip { position: fixed; pointer-events: none; background: var(--text-primary);
       color: var(--surface-1); padding: 4px 8px; border-radius: 4px;
       font-size: 12px; display: none; z-index: 9; }
</style></head><body>
<h1 id="title">study</h1>
<div class="sub" id="sub"></div>
<div class="kpis" id="kpis"></div>
<div class="charts">
  <div class="chart"><h2>Optimization history</h2>
    <div class="legend"><span class="sw" style="background:var(--series-1)"></span>trial value
      <span class="sw" style="background:var(--series-2)"></span>best so far</div>
    <svg id="hist" width="460" height="220"></svg></div>
  <div class="chart"><h2>Intermediate values</h2>
    <div class="legend"><span class="sw" style="background:var(--series-1)"></span>best trial
      <span class="sw" style="background:var(--muted-series)"></span>other trials</div>
    <svg id="inter" width="460" height="220"></svg></div>
</div>
<div class="chart"><h2>Trials</h2><table id="trials"></table></div>
<div id="tip"></div>
<script>
const NS = "http://www.w3.org/2000/svg";
const tip = document.getElementById("tip");
// journal content (param values, study name) is untrusted — escape
// before any innerHTML interpolation (stored-XSS guard)
const esc = s => String(s).replace(/[&<>"']/g, ch => (
  {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[ch]));
function el(p, n, at) { const e = document.createElementNS(NS, n);
  for (const k in at) e.setAttribute(k, at[k]); p.appendChild(e); return e; }
function hover(e, text) {
  e.addEventListener("mousemove", ev => { tip.style.display = "block";
    tip.style.left = (ev.clientX + 12) + "px";
    tip.style.top = (ev.clientY + 12) + "px"; tip.textContent = text; });
  e.addEventListener("mouseleave", () => tip.style.display = "none");
}
function scales(svg, xs, ys) {
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  const m = {l: 42, r: 10, t: 8, b: 22};
  const x0 = Math.min(...xs), x1 = Math.max(...xs, x0 + 1e-9);
  const y0 = Math.min(...ys), y1 = Math.max(...ys, y0 + 1e-9);
  const px = v => m.l + (v - x0) / (x1 - x0) * (W - m.l - m.r);
  const py = v => H - m.b - (v - y0) / (y1 - y0) * (H - m.t - m.b);
  // recessive hairline grid + end labels
  for (const f of [0, 0.5, 1]) {
    const yv = y0 + f * (y1 - y0), yy = py(yv);
    el(svg, "line", {x1: m.l, x2: W - m.r, y1: yy, y2: yy,
                     stroke: "var(--grid)", "stroke-width": 1});
    const t = el(svg, "text", {x: 2, y: yy + 3});
    t.textContent = yv.toPrecision(3);
  }
  for (const f of [0, 1]) {
    const xv = x0 + f * (x1 - x0);
    const t = el(svg, "text", {x: px(xv) - 4, y: H - 6});
    t.textContent = Math.round(xv);
  }
  return {px, py};
}
function render(r) {
  document.getElementById("title").textContent =
    "study “" + r.study + "”";
  document.getElementById("sub").textContent =
    r.direction + " · auto-refreshes every 10s";
  const states = {};
  for (const t of r.trials) states[t.state] = (states[t.state] || 0) + 1;
  const kp = [["trials", r.n_trials],
              ["complete", states.complete || 0],
              ["pruned", states.pruned || 0],
              ["running", states.running || 0],
              ["best", r.best ? r.best.value.toPrecision(5) : "—"]];
  document.getElementById("kpis").innerHTML = kp.map(
    ([l, v]) => `<div class="tile"><div class="v">${esc(v)}</div>` +
                `<div class="l">${esc(l)}</div></div>`).join("");

  const done = r.trials.filter(t => t.value != null);
  const hist = document.getElementById("hist"); hist.innerHTML = "";
  if (done.length) {
    const {px, py} = scales(hist, done.map(t => t.number),
                            done.map(t => t.value));
    let best = null, pts = [];
    for (const t of done) {
      best = best == null ? t.value :
        (r.direction === "maximize" ? Math.max(best, t.value)
                                    : Math.min(best, t.value));
      pts.push(px(t.number) + "," + py(best));
    }
    el(hist, "polyline", {points: pts.join(" "), fill: "none",
      stroke: "var(--series-2)", "stroke-width": 2,
      "stroke-linejoin": "round", "stroke-linecap": "round"});
    for (const t of done) {
      const c = el(hist, "circle", {cx: px(t.number), cy: py(t.value), r: 4,
        fill: "var(--series-1)", stroke: "var(--surface-2)",
        "stroke-width": 2});
      hover(c, "#" + t.number + ": " + t.value.toPrecision(5));
    }
  }

  const inter = document.getElementById("inter"); inter.innerHTML = "";
  const withI = r.trials.filter(t => t.intermediate.length > 1);
  if (withI.length) {
    const xs = withI.flatMap(t => t.intermediate.map(p => p[0]));
    const ys = withI.flatMap(t => t.intermediate.map(p => p[1]));
    const {px, py} = scales(inter, xs, ys);
    const bestNo = r.best ? r.best.number : -1;
    for (const t of withI) {  // emphasis: best trial on top in accent
      if (t.number === bestNo) continue;
      const pl = el(inter, "polyline", {
        points: t.intermediate.map(p => px(p[0]) + "," + py(p[1])).join(" "),
        fill: "none", stroke: "var(--muted-series)", "stroke-width": 2,
        "stroke-linejoin": "round"});
      hover(pl, "trial #" + t.number);
    }
    const bt = withI.find(t => t.number === bestNo);
    if (bt) {
      const pl = el(inter, "polyline", {
        points: bt.intermediate.map(p => px(p[0]) + "," + py(p[1])).join(" "),
        fill: "none", stroke: "var(--series-1)", "stroke-width": 2,
        "stroke-linejoin": "round"});
      hover(pl, "best trial #" + bt.number);
    }
  }

  const cols = ["number", "state", "value", "reported", "params"];
  const bestNo = r.best ? r.best.number : -1;
  document.getElementById("trials").innerHTML =
    "<tr>" + cols.map(c => "<th>" + c + "</th>").join("") + "</tr>" +
    r.trials.map(t => "<tr>" + cols.map(c => {
      let v = t[c];
      if (c === "value") v = v == null ? "—" : v.toPrecision(5);
      if (c === "params") v = Object.entries(t.params).map(
        ([k, x]) => k + "=" + (typeof x === "number" ? x.toPrecision(4) : x))
        .join(", ");
      const cls = (t.number === bestNo && c === "value") ? " class=best" : "";
      return "<td" + cls + ">" + esc(v) + "</td>";
    }).join("") + "</tr>").join("");
}
async function tick() {
  try { render(await (await fetch("/api/report")).json()); }
  catch (e) { document.getElementById("sub").textContent = "fetch failed: " + e; }
}
tick(); setInterval(tick, 10000);
</script></body></html>
"""


def make_server(storage: str, study_name: str = "study", port: int = 8080) -> HTTPServer:
    """An HTTP server on every interface (not yet serving) whose
    `/api/report` is `study_report(storage, study_name)`, read anew each
    request, and whose other paths are the page; port 0 takes a free one."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/api"):
                body = json.dumps(study_report(storage, study_name)).encode()
                ctype = "application/json"
            else:
                body = _PAGE.encode()
                ctype = "text/html; charset=utf-8"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return HTTPServer(("0.0.0.0", port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--storage", required=True)
    p.add_argument("--study_name", default="study")
    p.add_argument("--port", type=int, default=None,
                   help="serve the dashboard UI (JSON at /api/report)")
    args = p.parse_args(argv)
    if args.port is None:
        print(json.dumps(study_report(args.storage, args.study_name), indent=2))
        return
    server = make_server(args.storage, args.study_name, port=args.port)
    print(f"dashboard on http://0.0.0.0:{server.server_port} "
          f"(study {args.study_name!r}, storage {args.storage})")
    with server:
        server.serve_forever()


if __name__ == "__main__":
    main()
