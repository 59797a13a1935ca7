"""PyTorch port: the directional-sweep path in float64 (ROADMAP C.10).

With `SolverConfig(dtype="float64")` the JAX package solves
`method="sweep"`; the port's plain versions must take float64 too: the
radial sweep's twin `rsweep_reference` equals the JAX Pallas kernel in
interpret mode bit for bit (one add a candidate, order-free minimum),
and `AnnulusSolver(method="sweep")` on the CPU takes the JAX package's
4 rounds at 48x12 (spacing 150) from the innermost node at theta 0,
with a largest finite time of 610.4519199802852 s and every node within
1e-9 s (float64 rounding of the same sums in another order: the JAX
AnnulusSolver runs its XLA engine).  Every CUDA kernel has a float64
build (ROADMAP C.11 closed the last two, `rsweep` and `band`): each
wrapper's dtype check on its CUDA branch takes float32 and float64
(the shared check is called here directly: a CUDA tensor cannot be made
on this machine), and the kernel's packed float64 taps
(`plan_rsweep`) give the plain sweep's floats.
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
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    stencil's, and the kernel's tap packer takes float64 without
    rounding the weights: its near table is float64, its far entries
    carry the weight's 64 bits (offset, 0, low, high), and the packed
    form evaluates to the plain sweep's floats."""
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
    plan = psw.plan_rsweep(wdn, rst, False)
    assert plan.near.dtype == np.float64 and plan.w.dtype == np.float64
    assert plan.ent.shape == (len(plan.w), 4) and plan.ent.dtype == np.int32
    assert np.array_equal(plan.ent[:, 2:].copy().view(np.float64)[:, 0],
                          plan.w)
    assert (plan.ent[:, 1] == 0).all()
    assert plan.smem_bytes == psw.rsweep_smem_bytes(rst, plan.ent_cap, 8)
    rng = np.random.default_rng(11)
    buf = np.full((2, rst.MT + rst.K8, rst.NTL), np.inf)
    vals = rng.uniform(0.0, 1500.0, (2, rst.MT, cg.ntheta))
    vals[rng.random(vals.shape) < 0.3] = np.inf
    buf[:, :rst.MT, :cg.ntheta] = vals
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                                torch.from_numpy(wdn), rst, False)
    got = psw.rsweep_packed_reference(torch.from_numpy(buf.copy()), plan,
                                      rst, False)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    with pytest.raises(TypeError, match="float32 or float64"):
        psw.plan_rsweep(wdn.astype(np.float16), rst, False)


@pytest.mark.parametrize("kernel", ["rsweep", "titer", "band", "diag"])
def test_card_refuses_float64_naming_c10(kernel):
    """Every kernel takes float64 on the card (ROADMAP C.11 closed:
    rsweep and band were the last): the shared check takes float32 and
    float64 and refuses any other type with the kernel's name, and the
    float32-only check that named C.11 is gone."""
    kernels.require_float(kernel, torch.float64)     # no error
    kernels.require_float(kernel, torch.float32)     # no error
    with pytest.raises(TypeError, match=f"{kernel} kernel takes float32 "
                                        f"or float64"):
        kernels.require_float(kernel, torch.float16)
    assert not hasattr(kernels, "require_float32")


@pytest.mark.parametrize("module,wrapper,kernel", [
    ("ops/sweep_theta.py", "rsweep", "rsweep"),
    ("ops/wrapped_t.py", "titer", "titer"),
    ("ops/stream_t.py", "band", "band"),
    ("ops/diag_circulant.py", "diag_sweep", "diag")])
def test_float32_kernels_check_dtype_on_their_cuda_branch(module, wrapper,
                                                          kernel):
    """Each wrapper checks its kernel's dtype after its CPU branch has
    returned (the plain version takes any float type): every kernel by
    kernels.require_float (float32 or float64), with the kernel's name,
    and none by a float32-only check."""
    with open(os.path.join(ROOT, "raytracer_tpu_torch", module)) as f:
        text = f.read()
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef) and n.name == wrapper)
    src = ast.get_source_segment(text, fn)
    assert f'kernels.require_float("{kernel}",' in src
    assert "require_float32" not in text
    assert src.index("require_float") > src.index('device.type == "cpu"')


def test_float64_rsweep_plan_routes_by_its_bytes():
    """The float64 ring and tap buffers take twice the shared memory: a
    640-lane block whose float32 ring fits in 227 KB takes the device-
    memory route in float64; 180x63 keeps the ring in both types.  The
    float64 plan holds the float32 plan's taps with their float64 bits."""
    _, cg, _ = pt.init_annulus_circulant(180, 63, 20.0, dtype=np.float64)
    ws = pack_twrapped_stencil(cg, dtype=np.float64, band_closure=0)
    (wdn, _), rst = psw.pack_rsweep_tables(ws, cg, np.float64)
    for st, shared32, shared64 in ((rst, True, True),
                                   (rst._replace(NTL=640, NTB=640), True,
                                    False)):
        p64 = psw.plan_rsweep(wdn, st, False)
        p32 = psw.plan_rsweep(wdn.astype(np.float32), st, False)
        assert (p32.shared, p64.shared) == (shared32, shared64)
        assert p64.smem_bytes == psw.rsweep_smem_bytes(st, p64.ent_cap, 8)
        assert (p64.smem_bytes <= kernels.BLOCK_SMEM) == shared64
        np.testing.assert_array_equal(p64.dm, p32.dm)
        np.testing.assert_array_equal(p64.dc, p32.dc)
        np.testing.assert_array_equal(p64.binfo, p32.binfo)
        if shared32 == shared64:
            np.testing.assert_array_equal(p64.ent[:, 0], p32.ent[:, 0])
        else:   # the device-memory route packs (dm << 3) | (dc + 2)
            np.testing.assert_array_equal(p64.ent[:, 0],
                                          p64.dm * 8 + p64.dc + 2)
        assert np.array_equal(p64.w.astype(np.float32), p32.w)


def test_band_window_fits_or_is_refused_by_name():
    """band keeps 32 ring rows of 128 + 2*maxdm lanes: in float64 maxdm
    up to 390 fits an H100 block's 232,448 bytes, 391 does not (the
    wrapper refuses it with ValueError before the launch); the stream
    engine's widest window at 1080x300 is maxdm = 8."""
    from raytracer_tpu_torch.ops import stream_t

    assert stream_t.band_smem_bytes(390, 8) <= kernels.BLOCK_SMEM
    assert stream_t.band_smem_bytes(391, 8) > kernels.BLOCK_SMEM
    assert stream_t.band_smem_bytes(8, 8) == 32 * 144 * 8
    _, cg, _ = pt.init_annulus_circulant(1080, 300, 20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float64, band_closure=1)
    assert ws.maxdm == 8
    assert stream_t.band_smem_bytes(ws.maxdm, 8) <= kernels.BLOCK_SMEM
    with open(os.path.join(ROOT, "raytracer_tpu_torch", "ops",
                           "stream_t.py")) as f:
        text = f.read()
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef) and n.name == "band")
    src = ast.get_source_segment(text, fn)
    assert src.index("BLOCK_SMEM") < src.index("band_launch")
