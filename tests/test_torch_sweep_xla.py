"""PyTorch port: the xla sweep engine against the JAX package.

The JAX package's pure-jnp directional-sweep engine (`engine="xla"`, the
default of its `solve_circulant_sweep`) has six modes; the port's
counterpart runs the column sweeps through `tsweep` (the kernel
`csrc/tsweep.cu` on the card, the plain `_sweep` here) and the radial
sweeps `_sweep_r`, the scans and the closure as plain tensor code.  On
the 48x12 annulus (spacing 150 km), as tests/test_theta_shard.py uses:

  * `_sweep` (both directions, col_relax on and off, carry_init given
    and not) equals the JAX package's bit for bit in float64 and in
    float32, and `_sweep_r` (row_relax, seam_blind) in float64: one add
    a candidate, an exact minimum, and the ring costs s * ring_f the
    same single products;
  * `solve_circulant_sweep(engine="xla", mode=m)` for all six modes
    takes the JAX package's rounds, with every value equal bit for bit
    in float64; in float32 two modes are held within 1e-3 s (one ulp at
    1000 s is 6e-5 s);
  * the production route is unchanged: `engine="pallas"` is what
    `AnnulusSolver(method="sweep")` runs, and the defaults are the JAX
    package's (engine "xla", mode "hclosure").
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil as jpack
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil as ppack

MODES = ["theta", "r", "both", "kernel", "kernel-r", "hclosure"]
F32_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(dt):
    jgr, jcg, _ = rt.init_annulus_circulant(48, 12, 150.0, dtype=dt)
    gr, cg, _ = pt.init_annulus_circulant(48, 12, 150.0, dtype=dt)
    jws = jpack(jcg, dtype=dt, band_closure=0)
    ws = ppack(cg, dtype=dt, band_closure=0)
    jt, js = jsw.pack_sweep_tables(jws, jcg, dt)
    t, s = psw.pack_sweep_tables(ws, cg, dt)
    rng = np.random.default_rng(7)
    v = rng.uniform(0.0, 1500.0, (2, s.nt, s.ML)).astype(dt)
    v[rng.random(v.shape) < 0.5] = np.inf
    carry = tuple(rng.uniform(0.0, 1500.0, (2, s.ML)).astype(dt)
                  for _ in range(2))
    return dict(dt=dt, jcg=jcg, jws=jws, jt=jt, js=js, cg=cg, ws=ws, gr=gr,
                t=psw.tables_to_device(t, "cpu"), s=s, v=v, carry=carry)


@pytest.fixture(scope="module")
def tables64():
    return _tables(np.float64)


@pytest.fixture(scope="module")
def tables32():
    return _tables(np.float32)


@pytest.fixture(params=["f64", "f32"])
def tables(request):
    return request.getfixturevalue(f"tables{request.param[1:]}")


@pytest.mark.parametrize("with_carry", [False, True], ids=["wrap", "carry"])
@pytest.mark.parametrize("col_relax", [True, False])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_sweep_equals_jax(tables, reverse, col_relax, with_carry):
    T = tables
    ci = T["carry"] if with_carry else None
    want = np.asarray(jsw._sweep(
        jnp.asarray(T["v"]), T["jt"], T["js"], reverse, col_relax,
        None if ci is None else tuple(map(jnp.asarray, ci))))
    got = psw.tsweep(torch.from_numpy(T["v"]), T["t"], T["s"], reverse,
                     col_relax, None if ci is None
                     else tuple(map(torch.from_numpy, ci)))
    assert got.dtype == torch.from_numpy(T["v"]).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, T["v"])


@pytest.mark.parametrize("seam_blind", [False, True])
@pytest.mark.parametrize("row_relax", [True, False])
@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_sweep_r_equals_jax(tables64, upward, row_relax, seam_blind):
    T = tables64
    want = np.asarray(jsw._sweep_r(jnp.asarray(T["v"]), T["jt"], T["js"],
                                   upward, row_relax, seam_blind))
    got = psw._sweep_r(torch.from_numpy(T["v"]), T["t"], T["s"], upward,
                       row_relax, seam_blind)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt,mode", [("f64", m) for m in MODES]
                         + [("f32", "theta"), ("f32", "hclosure")])
def test_modes_equal_jax(request, dt, mode):
    T = request.getfixturevalue(f"tables{dt[1:]}")
    name = np.dtype(T["dt"]).name
    src = pt.closest_point(T["gr"], 0.0, pt.R, system="polar")
    want, rounds_j = jsw.solve_circulant_sweep(
        T["jcg"], src, JConfig(dtype=name), mode=mode, _packed=T["jws"])
    got, rounds = psw.solve_circulant_sweep(
        T["cg"], src, pt.SolverConfig(dtype=name), mode=mode, device="cpu",
        _packed=T["ws"])
    assert rounds == rounds_j
    if T["dt"] == np.float64:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_defaults_and_the_production_route(monkeypatch):
    sig = inspect.signature(psw.solve_circulant_sweep).parameters
    jsig = inspect.signature(jsw.solve_circulant_sweep).parameters
    for k in ("mode", "engine"):
        assert sig[k].default == jsig[k].default
    gr, cg, U = pt.init_annulus_circulant(16, 4, 400.0)
    calls = []
    real = psw.solve_circulant_sweep

    def spy(*a, **kw):
        calls.append(kw.get("engine"))
        return real(*a, **kw)

    monkeypatch.setattr("raytracer_tpu_torch.solvers.api."
                        "solve_circulant_sweep", spy)
    s = pt.AnnulusSolver(gr, None, None, U, method="sweep", circulant=cg,
                         device="cpu")
    s.solve(0, want_prev=False)
    assert calls == ["pallas"]
    with pytest.raises(ValueError, match="unknown mode"):
        psw.solve_circulant_sweep(cg, 0, mode="jacobi", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        psw.solve_circulant_sweep(cg, 0, engine="mosaic", device="cpu")


def test_tsweep_checks_its_arguments(tables64):
    T = tables64
    v = torch.from_numpy(T["v"])
    with pytest.raises(ValueError, match="must be"):
        psw.tsweep(v[:, :-1], T["t"], T["s"], False)
    with pytest.raises(ValueError, match="carry_init"):
        psw.tsweep(v, T["t"], T["s"], False, carry_init=(v[:, 0],))
    assert psw.tsweep_smem_bytes(896, 8) == 28672
