"""PyTorch port: the directional-sweep path in float64 (ROADMAP C.10).

With `SolverConfig(dtype="float64")` the JAX package solves
`method="sweep"`; the port's plain versions must take float64 too: the
radial sweep's twin `rsweep_reference` equals the JAX Pallas kernel in
interpret mode bit for bit (one add a candidate, order-free minimum),
and `AnnulusSolver(method="sweep")` on the CPU takes the JAX package's
4 rounds at 48x12 (spacing 150) from the innermost node at theta 0,
with a largest finite time of 610.4519199802852 s and every node within
1e-9 s (float64 rounding of the same sums in another order: the JAX
AnnulusSolver runs its XLA engine).  The CUDA kernels `rsweep` and
`band` have float32 builds only; on the card they refuse float64 with a
TypeError that names ROADMAP C.11, which queues their float64 builds
(their shared check is called here directly: a CUDA tensor cannot be
made on this machine).  `titer` and `diag` have float64 builds.
"""
import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import sweep_theta as jsw
import raytracer_tpu_torch as pt
from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT32_ONLY = ("rsweep", "band")   # their float64 builds: ROADMAP C.11
F64_ATOL = 1e-9
F64_ROUNDS = 4
F64_TMAX = 610.4519199802852


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    jgr, jcg, jU = rt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    gr, cg, U = pt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    return jgr, jcg, jU, gr, cg, U


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_rsweep_reference_float64_matches_pallas(grids, upward):
    _, _, _, _, cg, _ = grids
    ws = pack_twrapped_stencil(cg, dtype=np.float64, band_closure=0)
    (wdn, wup), rst = psw.pack_rsweep_tables(ws, cg, np.float64)
    wtab = wup if upward else wdn
    assert wtab.dtype == np.float64
    rng = np.random.default_rng(5 + int(upward))
    buf = np.full((2, rst.MT + rst.K8, rst.NTL), np.inf)
    off = rst.K8 if upward else 0
    vals = rng.uniform(0.0, 1500.0, (2, rst.MT, cg.ntheta))
    vals[rng.random(vals.shape) < 0.3] = np.inf
    buf[:, off:off + rst.MT, :cg.ntheta] = vals
    want = np.asarray(jsw._rsweep_call(jnp.asarray(buf), jnp.asarray(wtab),
                                       jsw.RSweepStatic(*rst), upward, True))
    assert want.dtype == np.float64
    got = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                               torch.from_numpy(wtab), rst, upward)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)


@pytest.mark.parametrize("method", ["sweep", "auto"])
def test_annulus_solver_float64_matches_jax(grids, method):
    jgr, jcg, jU, gr, cg, U = grids
    src = 0   # the innermost node at theta 0
    assert gr.r[src] == np.min(gr.r[gr.r > 0]) and gr.theta[src] == 0.0
    js = rt.AnnulusSolver(jgr, None, None, jU, JConfig(dtype="float64"),
                          method="sweep", circulant=jcg)
    want = np.asarray(js.solve(src, want_prev=False).dist)
    ps = pt.AnnulusSolver(gr, None, None, U, pt.SolverConfig(dtype="float64"),
                          method=method, circulant=cg, device="cpu")
    got = ps.solve(src, want_prev=False).dist
    assert ps.method == "sweep"
    assert got.dtype == np.float64 and want.dtype == np.float64
    assert ps.last_iterations == js.last_iterations == F64_ROUNDS
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.max(got[np.isfinite(got)]) == F64_TMAX
    assert np.max(want[np.isfinite(want)]) == F64_TMAX
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


def test_sweep_float64_keeps_its_dtype_on_every_buffer(grids):
    """The round's kernel buffers and tables follow the configured dtype:
    _to_T and _from_T keep the field's, pack_rsweep_tables the
    stencil's, and the kernel's tap packer refuses anything but float32
    rather than round the weights."""
    _, _, _, _, cg, _ = grids
    ws = pack_twrapped_stencil(cg, dtype=np.float64, band_closure=0)
    tbl, static = psw.pack_sweep_tables(ws, cg, np.float64)
    (wdn, _), rst = psw.pack_rsweep_tables(ws, cg, np.float64)
    assert all(np.asarray(a).dtype == np.float64
               for a in (tbl.cfp, tbl.cbp, tbl.fan_w, tbl.ring_f, wdn))
    v = torch.full((1, static.nt, static.ML), 1.0, dtype=torch.float64)
    buf = psw._to_T(v, rst, False)
    assert buf.dtype == torch.float64
    assert psw._from_T(buf, rst, static.nt, static.ML, False).dtype == \
        torch.float64
    with pytest.raises(TypeError, match="C.11"):
        psw.plan_rsweep(wdn, rst, False)


@pytest.mark.parametrize("kernel", ["rsweep", "titer", "band", "diag"])
def test_card_refuses_float64_naming_c10(kernel):
    """rsweep and band have float32 builds only: their check refuses
    float64 naming ROADMAP C.11, the item that queues their float64
    builds.  titer and diag have float64 builds: their check takes it."""
    if kernel in FLOAT32_ONLY:
        with pytest.raises(TypeError, match=r"ROADMAP C\.11"):
            kernels.require_float32(kernel, torch.float64)
        kernels.require_float32(kernel, torch.float32)   # no error
    else:
        kernels.require_float(kernel, torch.float64)     # no error
        with pytest.raises(TypeError, match="float32 or float64"):
            kernels.require_float(kernel, torch.float16)


@pytest.mark.parametrize("module,wrapper,kernel", [
    ("ops/sweep_theta.py", "rsweep", "rsweep"),
    ("ops/wrapped_t.py", "titer", "titer"),
    ("ops/stream_t.py", "band", "band"),
    ("ops/diag_circulant.py", "diag_sweep", "diag")])
def test_float32_kernels_check_dtype_on_their_cuda_branch(module, wrapper,
                                                          kernel):
    """Each wrapper checks its kernel's dtype after its CPU branch has
    returned (the plain version takes float64): the float32-only ones
    by kernels.require_float32, the others (float32 or float64) by
    kernels.require_float, with the kernel's name."""
    with open(os.path.join(ROOT, "raytracer_tpu_torch", module)) as f:
        text = f.read()
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef) and n.name == wrapper)
    src = ast.get_source_segment(text, fn)
    check = ("require_float32" if kernel in FLOAT32_ONLY
             else "require_float")
    assert f'kernels.{check}("{kernel}",' in src
    assert src.index(check) > src.index('device.type == "cpu"')
