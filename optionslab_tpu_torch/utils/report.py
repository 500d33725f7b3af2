"""Self-contained HTML desk report — the dashboard, as one artifact.

The port of ``optionslab_tpu/utils/report.py``, on the port's chain
calibration, VaR, exposure and plots, on ``device``.

The upstream project ships a 13-page Streamlit dashboard
(``streamlit_app/``); its capability is visual + tabular exploration of a
chain: smile fits, the fitted surface, arbitrage diagnostics, risk
numbers. Here the same
content renders into ONE dependency-free HTML file (PNGs base64-inlined,
tables as plain HTML) so it works over scp/CI artifacts — no app server.
The dashboard's *interactivity* is preserved too: the calibrated SVI
parameters are embedded in the page and evaluated by vanilla JS (smile
explorer with expiry/strike sliders, Black-Scholes calculator), so the
report stays a single offline artifact.

``build_report`` runs the full workflow: chain -> SVI slices + SSVI
(+ optional eSSVI) -> arbitrage report -> smile-fit and surface figures
-> VaR table -> optional exposure/XVA section, and writes the HTML.
matplotlib is required: without it ``build_report`` raises
``DependencyError`` before it calibrates anything.
"""
from __future__ import annotations

import base64
import datetime
import html
import io

import numpy as np

from ..data._table import as_table
from ..risk._frames import host

__all__ = ["build_report"]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2em auto; max-width: 1100px; color: #1a1a2e; }
h1 { border-bottom: 3px solid #16425b; padding-bottom: .3em; }
h2 { color: #16425b; margin-top: 1.6em; }
table { border-collapse: collapse; margin: .8em 0; font-size: 0.92em; }
th, td { border: 1px solid #c8d3dd; padding: .35em .7em; text-align: right; }
th { background: #e8eef3; }
td:first-child, th:first-child { text-align: left; }
img { max-width: 100%; border: 1px solid #dde5ec; margin: .5em 0; }
.ok { color: #1b7837; font-weight: 600; } .bad { color: #b2182b; font-weight: 600; }
.meta { color: #667; font-size: .85em; }
"""


def _fig_to_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _img(fig) -> str:
    return f'<img src="data:image/png;base64,{_fig_to_b64(fig)}"/>'


def _table(rows, header=None) -> str:
    out = ["<table>"]
    if header:
        out.append("<tr>" + "".join(f"<th>{html.escape(str(h))}</th>"
                                    for h in header) + "</tr>")
    for r in rows:
        cells = []
        for c in r:
            if isinstance(c, float):
                c = f"{c:.6g}"
            cells.append(f"<td>{html.escape(str(c))}</td>")
        out.append("<tr>" + "".join(cells) + "</tr>")
    out.append("</table>")
    return "".join(out)


def _flag(ok: bool) -> str:
    return f'<span class="{"ok" if ok else "bad"}">{"PASS" if ok else "FAIL"}</span>'


_EXPLORER_JS = """
function sviW(p, k) {
  var d = k - p[3];
  return p[0] + p[1] * (p[2] * d + Math.sqrt(d * d + p[4] * p[4]));
}
function erf(x) {  // Abramowitz-Stegun 7.1.26
  var s = x < 0 ? -1 : 1; x = Math.abs(x);
  var t = 1 / (1 + 0.3275911 * x);
  var y = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 +
          t * (-1.453152027 + t * 1.061405429))));
  return s * (1 - y * Math.exp(-x * x));
}
function ncdf(x) { return 0.5 * (1 + erf(x / Math.SQRT2)); }
function npdf(x) { return Math.exp(-0.5 * x * x) / Math.sqrt(2 * Math.PI); }
function bs(S, K, T, r, v, cp) {
  if (T <= 0 || v <= 0) {
    var intr = Math.max(cp * (S - K), 0);
    return {price: intr, delta: cp * (intr > 0 ? 1 : 0), gamma: 0, vega: 0};
  }
  var sq = v * Math.sqrt(T);
  var d1 = (Math.log(S / K) + (r + 0.5 * v * v) * T) / sq, d2 = d1 - sq;
  return {price: cp * (S * ncdf(cp * d1) - K * Math.exp(-r * T) * ncdf(cp * d2)),
          delta: cp * ncdf(cp * d1),
          gamma: npdf(d1) / (S * sq),
          vega: S * npdf(d1) * Math.sqrt(T)};
}
function drawSmile(idx) {
  idx = +idx;
  var p = SMILE.params[idx], T = SMILE.expiries[idx];
  var q = SMILE.quotes[idx], qk = q[0], qi = q[1];
  var kmin = -0.35, kmax = 0.35;
  if (qk.length) {
    kmin = Math.min.apply(null, qk) - 0.05;
    kmax = Math.max.apply(null, qk) + 0.05;
  }
  var xs = [], ys = [];
  for (var j = 0; j <= 100; j++) {
    var k = kmin + (kmax - kmin) * j / 100;
    xs.push(k); ys.push(Math.sqrt(Math.max(sviW(p, k), 1e-12) / T));
  }
  var ymin = Math.min.apply(null, ys.concat(qi)) * 0.95;
  var ymax = Math.max.apply(null, ys.concat(qi)) * 1.05;
  var W = 640, H = 300, L = 55, B = 34;
  function X(k) { return L + (k - kmin) / (kmax - kmin) * (W - L - 12); }
  function Y(v) { return (H - B) - (v - ymin) / (ymax - ymin) * (H - B - 12); }
  var s = '<line x1="' + L + '" y1="12" x2="' + L + '" y2="' + (H - B) +
          '" stroke="#99a"/><line x1="' + L + '" y1="' + (H - B) + '" x2="' +
          (W - 12) + '" y2="' + (H - B) + '" stroke="#99a"/>';
  for (var g = 0; g <= 4; g++) {
    var vv = ymin + (ymax - ymin) * g / 4;
    s += '<text x="' + (L - 6) + '" y="' + (Y(vv) + 4) +
         '" text-anchor="end" font-size="11" fill="#556">' +
         (100 * vv).toFixed(1) + '%</text>';
    var kk = kmin + (kmax - kmin) * g / 4;
    s += '<text x="' + X(kk) + '" y="' + (H - B + 16) +
         '" text-anchor="middle" font-size="11" fill="#556">' +
         kk.toFixed(2) + '</text>';
  }
  var path = '';
  for (j = 0; j <= 100; j++)
    path += (j ? 'L' : 'M') + X(xs[j]).toFixed(1) + ',' + Y(ys[j]).toFixed(1);
  s += '<path d="' + path + '" fill="none" stroke="#16425b" stroke-width="2"/>';
  for (j = 0; j < qk.length; j++)
    s += '<circle cx="' + X(qk[j]).toFixed(1) + '" cy="' + Y(qi[j]).toFixed(1) +
         '" r="3" fill="#b2182b" fill-opacity="0.75"/>';
  document.getElementById('smile-svg').innerHTML = s;
  document.getElementById('smile-label').textContent =
    'T = ' + T.toFixed(4) + ' y  (' + qk.length + ' quotes)';
  readStrike();
}
function readStrike() {
  var idx = +document.getElementById('smile-exp').value;
  var p = SMILE.params[idx], T = SMILE.expiries[idx];
  var k = +document.getElementById('smile-k').value;
  var iv = Math.sqrt(Math.max(sviW(p, k), 1e-12) / T);
  var F = SMILE.spot * Math.exp(SMILE.rate * T), K = F * Math.exp(k);
  var c = bs(SMILE.spot, K, T, SMILE.rate, iv, 1);
  document.getElementById('smile-read').textContent =
    'k=' + k.toFixed(2) + '  K=' + K.toFixed(2) + '  IV=' +
    (100 * iv).toFixed(2) + '%  call=' + c.price.toFixed(4) +
    '  \\u0394=' + c.delta.toFixed(4);
}
function calc() {
  var S = +document.getElementById('c-s').value,
      K = +document.getElementById('c-k').value,
      T = +document.getElementById('c-t').value,
      r = +document.getElementById('c-r').value,
      v = +document.getElementById('c-v').value,
      cp = +document.getElementById('c-cp').value;
  ['c-s', 'c-k', 'c-t', 'c-r', 'c-v'].forEach(function (id) {
    document.getElementById(id + '-lbl').textContent =
      document.getElementById(id).value;
  });
  var g = bs(S, K, T, r, v, cp);
  document.getElementById('c-out').innerHTML =
    '<b>price ' + g.price.toFixed(4) + '</b> &nbsp; \\u0394 ' +
    g.delta.toFixed(4) + ' &nbsp; \\u0393 ' + g.gamma.toFixed(5) +
    ' &nbsp; vega ' + g.vega.toFixed(3);
}
"""


def _interactive_section(res) -> str:
    """Dependency-free interactive explorer: the calibrated SVI slice
    parameters are embedded as JSON and evaluated in vanilla JS (SVG
    smile plot + per-strike readout + a Black-Scholes calculator) — the
    reference Streamlit dashboard's interactivity (``streamlit_app/
    Dashboard.py`` + pages) without an app server."""
    import json as _json

    params = [[float(getattr(p, f)) for f in
               ("a", "b", "rho", "m", "sigma")] for p in res.svi_params]
    quotes = [[np.round(host(k).astype(np.float64), 5).tolist(),
               np.round(host(iv).astype(np.float64), 5).tolist()]
              for k, iv in res.slice_quotes]
    data = {"expiries": [float(t) for t in res.expiries], "params": params,
            "quotes": quotes, "spot": float(res.spot),
            "rate": float(res.rate)}
    n = len(params)
    spot = float(res.spot)
    return f"""
<h2>Interactive explorer</h2>
<p class="meta">calibrated SVI slices evaluated live in this page — no
server; drag the sliders.</p>
<div>
 <label>expiry <input type="range" id="smile-exp" min="0" max="{n - 1}"
  step="1" value="0" oninput="drawSmile(this.value)"></label>
 <span id="smile-label" class="meta"></span><br>
 <svg id="smile-svg" width="640" height="300"
  style="border:1px solid #dde5ec;background:#fff"></svg><br>
 <label>log-moneyness k <input type="range" id="smile-k" min="-0.3"
  max="0.3" step="0.01" value="0" oninput="readStrike()"></label>
 <span id="smile-read" class="meta"></span>
</div>
<h3>Black&ndash;Scholes calculator</h3>
<div class="meta">
 <label>S <input type="range" id="c-s" min="{spot * 0.5:.4g}"
  max="{spot * 1.5:.4g}" step="{spot / 200:.4g}" value="{spot:.6g}"
  oninput="calc()"><span id="c-s-lbl"></span></label>
 <label>K <input type="range" id="c-k" min="{spot * 0.5:.4g}"
  max="{spot * 1.5:.4g}" step="{spot / 200:.4g}" value="{spot:.6g}"
  oninput="calc()"><span id="c-k-lbl"></span></label>
 <label>T <input type="range" id="c-t" min="0.02" max="3" step="0.02"
  value="1" oninput="calc()"><span id="c-t-lbl"></span></label><br>
 <label>r <input type="range" id="c-r" min="0" max="0.10" step="0.0025"
  value="{max(res.rate, 0.01):.4g}" oninput="calc()">
  <span id="c-r-lbl"></span></label>
 <label>&sigma; <input type="range" id="c-v" min="0.02" max="1.0"
  step="0.01" value="0.2" oninput="calc()"><span id="c-v-lbl"></span></label>
 <label>type <select id="c-cp" onchange="calc()">
  <option value="1">call</option><option value="-1">put</option>
 </select></label>
</div>
<p id="c-out"></p>
<script>
var SMILE = {_json.dumps(data)};
{_EXPLORER_JS}
drawSmile(0); calc();
</script>"""


def build_report(chain=None, *, out_path: str = "report.html",
                 n_expiry_bins: int = 4, n_steps: int = 400,
                 essvi: bool = True, include_boundary: bool = True,
                 include_xva: bool = True, n_rows: int = 500,
                 seed: int = 0, device="cuda") -> dict:
    """Run the chain workflow and write a self-contained HTML desk report.

    ``chain``: an ``OptionChainDataset``/DataFrame (default: the synthetic
    generator, so the command always has something to show).  Returns a
    summary dict (sections rendered, calibration RMSEs, output path).
    Raises ``DependencyError`` without matplotlib, before any fit.
    """
    from ..data.loader import load_option_data
    from ..surface.chain_calibration import calibrate_chain
    from . import plotting

    plt = plotting._plt()
    if chain is None:
        chain = load_option_data("synthetic", n_rows=n_rows, seed=seed, device=device)

    res = calibrate_chain(chain, n_expiry_bins=n_expiry_bins,
                          n_steps=n_steps, essvi=essvi, device=device)
    parts = [f"<style>{_CSS}</style>", "<h1>optionslab_tpu_torch desk report</h1>",
             f'<p class="meta">generated {datetime.datetime.now():%Y-%m-%d %H:%M} · '
             f'spot {res.spot:.4g} · rate {res.rate:.4g} · '
             f'{int(np.sum(res.n_quotes))} quotes in {len(res.expiries)} '
             f'expiries</p>']
    summary = {"out_path": out_path, "sections": []}

    # --- calibration section ------------------------------------------
    parts.append("<h2>Smile calibration (SVI per expiry)</h2>")
    parts.append(_img(plotting.plot_smile_fits(chain, res)))
    rows = [(f"{t:.4f}", int(n), f"{rm * 100:.2f}",
             f"{th:.5f}", _flag(bf))
            for t, n, rm, th, bf in zip(res.expiries, res.n_quotes,
                                        res.svi_rmse_vol, res.thetas,
                                        res.report["butterfly_free"])]
    parts.append(_table(rows, header=["expiry (y)", "quotes",
                                      "rmse (vol pts)", "ATM total var",
                                      "butterfly-free"]))
    summary["sections"].append("smiles")

    parts.append("<h2>Surface (SSVI" + (" + eSSVI" if essvi else "") + ")</h2>")
    parts.append(_img(plotting.plot_ssvi_surface(res)))
    srows = [("SSVI (global rho/eta/gamma)", f"{res.ssvi_rmse_vol * 100:.2f}",
              _flag(bool(res.report["ssvi_butterfly_free"])))]
    if essvi and res.essvi is not None:
        srows.append(("eSSVI (per-expiry rho/psi)",
                      f"{res.essvi_rmse_vol * 100:.2f}",
                      _flag(bool(res.report.get("essvi_arbitrage_free",
                                                False)))))
    parts.append(_table(srows, header=["model", "rmse (vol pts)", "no-arb"]))
    summary["sections"].append("surface")

    parts.append("<h2>Static no-arbitrage report</h2>")
    rep_rows = [(k, (_flag(v) if isinstance(v, (bool, np.bool_)) else
                     f"{v:.6g}" if isinstance(v, float) else str(v)))
                for k, v in res.report.items()
                if not isinstance(v, (list, dict))]
    parts.append(_table(rep_rows, header=["check", "value"]))
    summary["sections"].append("arbitrage")

    # --- interactive explorer (vanilla JS, no server) --------------------
    parts.append(_interactive_section(res))
    summary["sections"].append("interactive")

    # --- exercise boundary ---------------------------------------------
    if include_boundary:
        parts.append("<h2>American early-exercise boundary (LSM)</h2>")
        parts.append(_img(plotting.plot_exercise_boundary(
            spot=res.spot, strike=res.spot, rate=max(res.rate, 0.01),
            n_paths=20_000, n_dates=25, seed=seed, device=device)))
        summary["sections"].append("boundary")

    # --- risk ----------------------------------------------------------
    from ..risk import VaRAnalyzer

    a = VaRAnalyzer(confidence=0.95, seed=seed, device=device)
    table = as_table(chain)
    sigma_ref = (float(np.median(np.asarray(table["implied_volatility"], np.float64)))
                 if "implied_volatility" in table else 0.2)
    if not np.isfinite(sigma_ref) or sigma_ref <= 0:
        sigma_ref = 0.2
    notional = 1e6
    parts.append("<h2>Risk (95% one-year VaR on a 1M notional)</h2>")
    parts.append(_table([
        ("parametric", a.parametric(0.05, sigma_ref * notional)),
        ("lognormal", a.parametric_lognormal(notional, 0.05, sigma_ref)),
        ("monte carlo", a.monte_carlo(notional, 0.05, sigma_ref)),
    ], header=["method", "VaR"]))
    summary["sections"].append("risk")

    # --- XVA ------------------------------------------------------------
    if include_xva:
        from ..risk import Position, xva_report

        pos = Position(quantity=1.0, spot=res.spot, strike=res.spot,
                       maturity=1.0, rate=max(res.rate, 0.01),
                       vol=sigma_ref, option_type="call")
        xr = xva_report([pos], hazard_rate=0.02, n_dates=12, n_paths=16384,
                        seed=seed, device=device)
        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.plot(host(xr["dates"]), host(xr["ee"]), label="EE")
        ax.plot(host(xr["dates"]), host(xr["pfe"]),
                label=f'PFE {float(xr["quantile"]):.0%}')
        ax.set_xlabel("time (y)")
        ax.set_ylabel("exposure")
        ax.set_title("counterparty exposure profile (ATM call)")
        ax.legend()
        fig.tight_layout()
        parts.append("<h2>Counterparty exposure & CVA</h2>")
        parts.append(_img(fig))
        parts.append(_table([
            ("EPE", float(xr["epe"])), ("max PFE", float(xr["max_pfe"])),
            ("CVA (λ=2%, R=40%)", float(xr["cva"])),
        ], header=["metric", "value"]))
        summary["sections"].append("xva")

    with open(out_path, "w") as f:
        f.write("<!DOCTYPE html><html><head><meta charset='utf-8'>"
                "<title>optionslab_tpu_torch report</title></head><body>"
                + "".join(parts) + "</body></html>")
    summary.update({
        "svi_rmse_vol": [float(x) for x in res.svi_rmse_vol],
        "ssvi_rmse_vol": float(res.ssvi_rmse_vol),
        "essvi_rmse_vol": (float(res.essvi_rmse_vol) if essvi else None),
        "arbitrage_free": bool(res.report["arbitrage_free"]),
    })
    return summary
