"""PyTorch port: the radial Gauss-Seidel sweep's plain version against the
JAX package's Pallas kernel (interpret mode), bit for bit.

Each candidate is one f32 add followed by a min, so the row-by-row torch
loop must give exactly the floats of the TPU kernel's 8-row
macro-blocks.  The CUDA kernel itself runs only on the card; chip_smoke.py
holds it bit-equal to `rsweep_reference` there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu_torch as pt
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil


def _statics(NTL, NTB, MT=24, K8=16):
    """Hand-made taps with |dm| below and above 8 and dc in -2..2."""
    pairs = [(1, 0), (1, -1), (2, 1), (3, 2), (5, -2), (8, 0), (9, 1),
             (12, -1), (16, 2), (7, -2)]
    taps_dn = tuple((dm, dc, i) for i, (dm, dc) in enumerate(pairs))
    taps_up = tuple((-dm, dc, i) for dm, dc, i in taps_dn)
    j = jsw.RSweepStatic(MT, K8, NTL, NTB, taps_dn, taps_up, 128, 128)
    return j, psw.RSweepStatic(*j)


def _field(rng, S, rst, inf_share=0.5):
    buf = rng.uniform(0.0, 100.0, (S, rst.MT + rst.K8, rst.NTL))
    buf[rng.random(buf.shape) < inf_share] = np.inf
    return buf.astype(np.float32)


def _weights(rng, rows, D, inf_share=0.2):
    w = rng.uniform(0.5, 3.0, (rows, D))
    w[rng.random(w.shape) < inf_share] = np.inf
    return w.astype(np.float32)


def _jax_sweep(buf, wtab, jrst, upward):
    return np.asarray(jsw._rsweep_call(jnp.asarray(buf), jnp.asarray(wtab),
                                       jrst, upward, True))


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("NTL,NTB", [(128, 128), (256, 128)],
                         ids=["one-block", "lane-blocked"])
def test_reference_matches_pallas_handmade(upward, NTL, NTB):
    rng = np.random.default_rng(1 + NTL + NTB + int(upward))
    jrst, prst = _statics(NTL, NTB)
    buf = _field(rng, 2, prst)
    wtab = _weights(rng, prst.MT + prst.K8, 128)
    want = _jax_sweep(buf, wtab, jrst, upward)
    got = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                               torch.from_numpy(wtab), prst, upward)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)  # the sweep did relax something


@pytest.fixture(scope="module")
def real_tables():
    _, cg, _ = pt.init_annulus_circulant(48, 12, 150.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    (wdn, wup), rst = psw.pack_rsweep_tables(ws, cg, np.float32)
    return cg, wdn, wup, rst


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_reference_matches_pallas_real_tables(real_tables, upward):
    cg, wdn, wup, rst = real_tables
    rng = np.random.default_rng(7 + int(upward))
    buf = np.full((2, rst.MT + rst.K8, rst.NTL), np.inf, np.float32)
    off = rst.K8 if upward else 0
    nt = cg.ntheta
    vals = rng.uniform(0.0, 1500.0, (2, rst.MT, nt))
    vals[rng.random(vals.shape) < 0.3] = np.inf
    buf[:, off:off + rst.MT, :nt] = vals
    wtab = wup if upward else wdn
    jrst = jsw.RSweepStatic(*rst)
    want = _jax_sweep(buf, wtab, jrst, upward)
    got = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                               torch.from_numpy(wtab), rst, upward)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_wrapper_on_cpu_takes_plain_path(real_tables, upward):
    """A CPU tensor goes to the plain version, in place, and never
    counts as a kernel launch."""
    cg, wdn, wup, rst = real_tables
    rng = np.random.default_rng(11)
    buf = _field(rng, 1, rst)
    wtab = torch.from_numpy(wup if upward else wdn)
    before = psw.rsweep.launches
    t = torch.from_numpy(buf.copy())
    out = psw.rsweep(t, wtab, rst, upward)
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()), wtab, rst,
                                upward)
    assert out is t                   # updated in place
    assert torch.equal(out, want)
    assert psw.rsweep.launches == before


def test_wrapper_rejects_bad_inputs(real_tables):
    _, wdn, _, rst = real_tables
    good = torch.full((1, rst.MT + rst.K8, rst.NTL), float("inf"))
    w = torch.from_numpy(wdn)
    with pytest.raises(TypeError):
        psw.rsweep(good.double(), w, rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good[:, :-1], w, rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good, w[:-1], rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good.transpose(1, 2).contiguous().transpose(1, 2), w,
                   rst, False)
    meta = torch.empty(good.shape, device="meta")
    with pytest.raises(ValueError):
        psw.rsweep(meta, w.to("meta"), rst, False)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build says so; the library name
    follows the source's hash."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "DEFAULT_CUDA_BIN", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    path = kernels.library_path("rsweep")
    assert path.startswith(kernels.BUILD_DIR)
    assert path.endswith(".so") and "librsweep_" in path


def test_kernel_source_interface():
    """The CUDA source exposes the plain C launch function the wrapper
    binds with ctypes, and nothing of PyTorch's C++ extension API."""
    with open(kernels.source_path("rsweep")) as f:
        src = f.read()
    assert 'extern "C" int rsweep_launch(' in src
    assert "cudaGetLastError()" in src
    assert "torch/extension.h" not in src
    assert "_make_rsweep_kernel" in src   # names the TPU kernel it replaces
