"""``fdm_price``'s grid against the reference's, bit for bit.

The grid puts log K mid-cell: ``frac = ((log K − x[0]) / dx) mod 1`` picks the
shift. At S0 = K that is a tie (an integer in exact arithmetic), and which
side rounding lands on moves the grid by a whole cell. The port builds the
nodes with the reference's own roundings (XLA's linspace, one rounding for
each multiply-add its fused loops contract), so x[0] and dx equal the
reference's and both packages break the tie the same way. Held at S0 = K for
41, 81 and 201 nodes in float32 and float64, at spots either side of the
strike, and through the American put at 41 x 40 and 81 x 80 on both sides of
the tie. The reference's ``_grid`` runs jitted, as ``fdm_price`` runs it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu.models import fdm as jfdm
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models import fdm as tfdm
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 100.0
DTYPES = {"float32": (torch.float32, jnp.float32, False),
          "float64": (torch.float64, jnp.float64, True)}


def _grids(spots, n, dtype_name, vol=0.2, maturity=1.0):
    """(port x, port dx, reference x, reference dx) for a book of spots."""
    tdt, jdt, x64 = DTYPES[dtype_name]
    fields = [np.asarray(v, np.float64) * np.ones(len(spots))
              for v in (spots, vol, maturity, K)]
    with jax.enable_x64(x64):
        grid = jax.jit(jax.vmap(lambda s, v, t, k: jfdm._grid(s, v, t, n, 6.0, k)))
        xr, dxr = grid(*(jnp.asarray(f, jdt) for f in fields))
        xr, dxr = np.asarray(xr), np.asarray(dxr)
    t = [torch.tensor(f, dtype=tdt) for f in fields]
    x, dx = tfdm._grid(t[0], t[1], t[2], n, 6.0, t[3])
    return x.numpy(), dx.numpy(), xr, dxr


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n", [41, 81, 201])
def test_grid_at_the_tie_equals_the_reference(n, dtype_name):
    """S0 = K: x[0] and dx bit for bit, hence the same side of the tie and
    the same nodes throughout."""
    x, dx, xr, dxr = _grids([K], n, dtype_name)
    assert x.dtype == xr.dtype
    assert x[0, 0] == xr[0, 0] and dx[0] == dxr[0]
    np.testing.assert_array_equal(x, xr)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n", [41, 81, 201])
def test_grid_off_the_tie_equals_the_reference(n, dtype_name):
    """Spots below and above the strike (whose logs both packages round
    alike): x[0] and dx bit for bit."""
    x, dx, xr, dxr = _grids([80.0, 90.0, 110.0, 123.4], n, dtype_name)
    np.testing.assert_array_equal(x[:, 0], xr[:, 0])
    np.testing.assert_array_equal(dx, dxr)


def test_unit_linspace_is_the_references():
    """``jnp.linspace(-1, 1, n)`` bit for bit, where ``torch.linspace``
    rounds inner nodes differently."""
    for dtype_name, (tdt, jdt, x64) in DTYPES.items():
        with jax.enable_x64(x64):
            for n in (2, 3, 41, 57, 81, 201, 401):
                ref = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n, dtype=jdt))())
                port = tfdm._unit_linspace(n, tdt, "cpu").numpy()
                np.testing.assert_array_equal(port, ref, err_msg=f"{dtype_name} {n}")


def test_fma_rounds_once():
    """a·b + c rounded once: the float64 two-product and two-sum against the
    exact value, where the unfused form rounds twice."""
    a = torch.tensor([1.0 + 2.0**-30, 0.1, -0.95], dtype=torch.float64)
    b = torch.tensor([1.0 - 2.0**-30, 1.2, 1.2], dtype=torch.float64)
    c = torch.tensor([-1.0, 4.605170185988092, 4.605170185988092], dtype=torch.float64)
    from fractions import Fraction

    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())]
    assert tfdm._fma(a, b, c).tolist() == want
    assert (a * b + c).tolist()[0] != want[0]
    f32 = [t.to(torch.float32) for t in (a, b, c)]
    want32 = [np.float32(float(Fraction(x) * Fraction(y) + Fraction(z)))
              for x, y, z in zip(*(t.tolist() for t in f32))]
    assert tfdm._fma(*f32).tolist() == [float(w) for w in want32]


@pytest.mark.parametrize("n_space,n_time,dtype_name", [(41, 40, "float32"), (81, 80, "float64"),
                                                       (41, 40, "float64"),
                                                       (81, 80, "float32")])
def test_american_put_at_the_tie_matches_the_reference(n_space, n_time, dtype_name):
    """The American put at S0 = K where the two packages once took opposite
    sides of the tie (6.0585 against 6.0522 at 41 x 40 in float32; 1.2e-4
    apart at 81 x 80 in float64): now within 1e-5 relative, the θ-scheme's
    float rounding."""
    tdt, jdt, x64 = DTYPES[dtype_name]
    with jax.enable_x64(x64):
        jb = JBatch.make(K, K, 1.0, 0.05, 0.2, "put", dtype=jdt)
        ref = float(jfdm.fdm_price(jb, n_space=n_space, n_time=n_time, american=True))
    tb = ContractBatch.make(K, K, 1.0, 0.05, 0.2, "put", dtype=tdt, device="cpu")
    port = float(tfdm.fdm_price(tb, n_space=n_space, n_time=n_time, american=True))
    assert port == pytest.approx(ref, rel=1e-5)
