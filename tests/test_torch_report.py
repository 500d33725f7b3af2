"""The port's plots (``optionslab_tpu_torch.utils.plotting``) and HTML desk
report (``optionslab_tpu_torch.utils.report``) against the JAX package's
on the CPU.

The plots draw what the reference's draw: the same panels and artists,
written as PNG files. ``build_report`` at a small ``n_steps`` writes the
same sections and summary keys as the reference's on the same synthetic
chain, its fits within 5e-4 vol (float32 Adam in both). Without
matplotlib every plot and the report raise ``DependencyError`` before any
fit (the reference's report calibrates first).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.data.loader import load_option_data as j_load
from optionslab_tpu.surface.chain_calibration import calibrate_chain as j_calibrate
from optionslab_tpu.utils import plotting as jplot
from optionslab_tpu.utils.report import build_report as j_build_report
from optionslab_tpu_torch.data.loader import load_option_data
from optionslab_tpu_torch.surface.chain_calibration import calibrate_chain
from optionslab_tpu_torch.utils import plotting
from optionslab_tpu_torch.utils.exceptions import DependencyError
from optionslab_tpu_torch.utils.report import build_report

CPU = "cpu"
SECTIONS = ("Smile calibration", "Surface", "no-arbitrage", "Interactive explorer",
            "exercise boundary", "Risk", "CVA")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    return load_option_data("synthetic", n_rows=300, seed=3, device=CPU)


@pytest.fixture(scope="module")
def result(chain):
    return calibrate_chain(chain, n_expiry_bins=4, n_steps=120, device=CPU)


@pytest.fixture(scope="module")
def ref_result():
    with jax.enable_x64(False):
        ch = j_load("synthetic", n_rows=300, seed=3)
        return ch, j_calibrate(ch, n_expiry_bins=4, n_steps=120)


def _artists(ax):
    return len(ax.lines), len(ax.collections), ax.get_xlabel(), ax.get_ylabel()


def test_smile_fits_png(chain, result, ref_result, tmp_path):
    out = tmp_path / "smiles.png"
    fig = plotting.plot_smile_fits(chain, result, path=str(out))
    ref = jplot.plot_smile_fits(*ref_result)
    assert out.stat().st_size > 10_000 and len(fig.axes) == len(ref.axes) >= 4
    for ax, rax in zip(fig.axes, ref.axes):
        assert _artists(ax) == _artists(rax) and ax.get_title() == rax.get_title()
        for line, rline in zip(ax.lines, rax.lines):
            np.testing.assert_allclose(line.get_xdata(), rline.get_xdata(), atol=1e-6)
            np.testing.assert_allclose(line.get_ydata(), rline.get_ydata(), atol=2e-3)


def test_ssvi_surface_png(result, ref_result, tmp_path):
    out = tmp_path / "ssvi.png"
    fig = plotting.plot_ssvi_surface(result, path=str(out))
    ref = jplot.plot_ssvi_surface(ref_result[1])
    assert out.stat().st_size > 10_000
    (ax,), (rax,) = fig.axes, ref.axes
    assert _artists(ax) == _artists(rax) and ax.get_zlabel() == rax.get_zlabel()


def test_boundary_png(tmp_path):
    """The boundary from a torch generator on the device: a put's critical
    spot below the strike and rising towards it (other draws than the
    reference's PRNG key)."""
    out = tmp_path / "bdry.png"
    fig = plotting.plot_exercise_boundary(n_paths=8_192, n_dates=20, path=str(out), device=CPU)
    assert out.stat().st_size > 10_000
    (line, _strike) = fig.axes[0].lines
    b = np.asarray(line.get_ydata())
    assert b.shape == (19,)
    b = b[np.isfinite(b)]  # NaN where no path exercised
    assert b.size > 10 and np.all(b < 100.0) and b[-1] > b[0]
    ref = jplot.plot_exercise_boundary(n_paths=8_192, n_dates=20)
    assert _artists(fig.axes[0]) == _artists(ref.axes[0])


def test_build_report_matches_the_reference(chain, tmp_path):
    out, ref_out = tmp_path / "port.html", tmp_path / "ref.html"
    kw = dict(n_expiry_bins=4, n_steps=80, essvi=True, include_boundary=True, include_xva=True)
    summary = build_report(chain, out_path=str(out), device=CPU, **kw)
    with jax.enable_x64(False):
        ref = j_build_report(j_load("synthetic", n_rows=300, seed=3), out_path=str(ref_out), **kw)
    assert summary.keys() == ref.keys()
    assert summary["sections"] == ref["sections"] == ["smiles", "surface", "arbitrage",
                                                      "interactive", "boundary", "risk", "xva"]
    np.testing.assert_allclose(summary["svi_rmse_vol"], ref["svi_rmse_vol"], atol=5e-4)
    assert summary["ssvi_rmse_vol"] == pytest.approx(ref["ssvi_rmse_vol"], abs=5e-4)
    assert summary["essvi_rmse_vol"] == pytest.approx(ref["essvi_rmse_vol"], abs=5e-4)
    text, ref_text = out.read_text(), ref_out.read_text()
    for section in SECTIONS:
        assert section in text, section
    assert text.count("data:image/png;base64,") == ref_text.count("data:image/png;base64,") >= 3
    assert text.count("<tr>") == ref_text.count("<tr>")
    assert "var SMILE = {" in text and "function sviW" in text and "drawSmile(0)" in text


def test_build_report_minimal(chain, tmp_path):
    out = tmp_path / "mini.html"
    summary = build_report(chain, out_path=str(out), n_expiry_bins=4, n_steps=60, essvi=False,
                           include_boundary=False, include_xva=False, device=CPU)
    assert summary["sections"] == ["smiles", "surface", "arbitrage", "interactive", "risk"]
    assert summary["essvi_rmse_vol"] is None
    assert out.stat().st_size > 30_000


@pytest.mark.parametrize("call", [
    lambda c, r, p: plotting.plot_smile_fits(c, r, path=p),
    lambda c, r, p: plotting.plot_ssvi_surface(r, path=p),
    lambda c, r, p: plotting.plot_exercise_boundary(path=p, device=CPU),
    lambda c, r, p: build_report(c, out_path=p, device=CPU),
], ids=["smiles", "ssvi", "boundary", "report"])
def test_without_matplotlib_raises_before_any_work(call, chain, result, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    fits = []
    monkeypatch.setattr("optionslab_tpu_torch.surface.chain_calibration.calibrate_chain",
                        lambda *a, **k: fits.append(a))
    path = tmp_path / "x"
    with pytest.raises(DependencyError, match="matplotlib"):
        call(chain, result, str(path))
    assert not path.exists() and fits == []
