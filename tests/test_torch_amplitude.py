"""PyTorch port: the amplitude models and `main_annulus --q`.

The port keeps its own copies of the JAX package's NumPy model modules
(`models/{raytheory,flatearth,zoeppritz,amplitude,iasp91,interpolation}`;
it may import nothing of the JAX package).  Each copied function is held
equal to its original on the same inputs, bit for bit; the iasp91 table
the copy generates equals the port's vendored file; the JAX package's
analytic anchors run on the port; and the port's `main_annulus --q`
columns equal the JAX functions applied to the port's own polylines, the
bent ones when `--refine` ran.
"""
import csv
import os

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu.models.amplitude as j_amp
import raytracer_tpu.models.flatearth as j_flat
import raytracer_tpu.models.iasp91 as j_iasp
import raytracer_tpu.models.interpolation as j_interp
import raytracer_tpu.models.raytheory as j_ray
import raytracer_tpu.models.zoeppritz as j_zoep
import raytracer_tpu_torch as pt
import raytracer_tpu_torch.models.amplitude as p_amp
import raytracer_tpu_torch.models.flatearth as p_flat
import raytracer_tpu_torch.models.iasp91 as p_iasp
import raytracer_tpu_torch.models.interpolation as p_interp
import raytracer_tpu_torch.models.raytheory as p_ray
import raytracer_tpu_torch.models.zoeppritz as p_zoep
import raytracer_tpu_torch.solvers.refine as p_refine
from raytracer_tpu_torch import main_annulus as p_main
from raytracer_tpu_torch.config import R

JAX = dict(amp=j_amp, flat=j_flat, iasp=j_iasp, interp=j_interp, ray=j_ray,
           zoep=j_zoep)
PORT = dict(amp=p_amp, flat=p_flat, iasp=p_iasp, interp=p_interp, ray=p_ray,
            zoep=p_zoep)
DEGS = np.array([12.0, 35.0, 61.0, 88.0, 101.0, 150.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers,
    and the twins' many small ops slow down badly when each worker's
    thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prof():
    prof = pt.velocity_profile("ak135")
    return prof.r, prof.Vp


def _polyline():
    rr = np.linspace(R - 900.0, R, 60)
    th = np.linspace(0.0, 0.3, 60)
    return np.stack([rr * np.sin(th), rr * np.cos(th)], axis=1)


def _media(m):
    return m["zoep"].interface_media(m["flat"].cmb_radius("ak135"))


def _quad():
    th = np.array([[0.1, 0.2, 0.2, 0.1], [0.3, 0.5, 0.5, 0.3]])
    r = np.array([[1.0, 1.0, 2.0, 2.0], [3.0, 3.0, 4.5, 4.5]])
    return th, r, 3.0 * th + 0.5 * r * r


# one case per copied function: name -> f(modules) -> result
CASES = {
    "raytheory._branch": lambda m: m["ray"]._branch(
        np.linspace(1e-4, 0.12, 40), _prof()[0], _prof()[1][1:]),
    "raytheory.first_arrival": lambda m: m["ray"].first_arrival(
        DEGS, *_prof(), n_p=600, return_p=True),
    "raytheory.reflected_arrival": lambda m: m["ray"].reflected_arrival(
        DEGS, *_prof(), 3479.5, n_p=600),
    "raytheory.ak135_reflected": lambda m: m["ray"].ak135_reflected(
        DEGS, 3479.5, n_p=600),
    "raytheory.ak135_first_arrivals": lambda m: m["ray"]
    .ak135_first_arrivals(DEGS, shell_km=20, n_p=600),
    "flatearth.RadialModel": lambda m: _radial_model(m["flat"]),
    "flatearth.table_model": lambda m: m["flat"].table_model(
        "ak135", "Vs").turning_radius(np.array([0.02, 0.05, 0.08])),
    "flatearth.cmb_radius": lambda m: [m["flat"].cmb_radius(x) for x in
                                       ("ak135", "iasp91")],
    "flatearth.converted_branch": lambda m: m["flat"].converted_branch(
        n_p=200),
    "flatearth.converted_first_arrival": lambda m: m["flat"]
    .converted_first_arrival(np.array([90.0, 110.0, 130.0]), n_p=200),
    "flatearth.depth_phase_branch": lambda m: m["flat"].depth_phase_branch(
        R - 100.0, "sP", n_p=200),
    "flatearth.depth_phase_first_arrival": lambda m: m["flat"]
    .depth_phase_first_arrival(DEGS[:4], 80.0, n_p=200, return_p=True),
    "flatearth.depth_from_depth_phase": lambda m: m["flat"]
    .depth_from_depth_phase(20.0, 50.0, n_p=150, tol_km=2.0),
    "zoeppritz.prem_density": lambda m: m["zoep"].prem_density(
        np.array([0.0, 1000.0, 1221.5, 3480.0, 5701.0, 6000.0, R])),
    "zoeppritz.interface_media": lambda m: [
        np.asarray([md.alpha, md.beta, md.rho]) for md in _media(m)],
    "zoeppritz.scattering": lambda m: m["zoep"].scattering(
        *_media(m), 0.03, "P"),
    "zoeppritz.energy_coefficients": lambda m: m["zoep"].energy_coefficients(
        *_media(m)[::-1], 0.02, "P"),
    "zoeppritz.free_surface_receiver": lambda m: m["zoep"]
    .free_surface_receiver(0.05, m["zoep"].Medium(5.8, 3.46, 2.6)),
    "zoeppritz.pcp_p_amplitude_ratio": lambda m: m["zoep"]
    .pcp_p_amplitude_ratio(DEGS, q_factor=600.0, n_p=300),
    "amplitude.tstar": lambda m: m["amp"].tstar(
        _polyline(), *_prof(), np.linspace(200.0, 600.0, 50),
        profile_q_r=np.linspace(0.0, R, 50)),
    "amplitude.attenuation_factor": lambda m: m["amp"].attenuation_factor(
        np.array([0.1, 0.5, 1.3]), 2.0),
    "amplitude.geometrical_spreading": lambda m: m["amp"]
    .geometrical_spreading(DEGS, *_prof(), n_p=600),
    "amplitude.ak135_spreading": lambda m: m["amp"].ak135_spreading(
        DEGS, shell_km=20, n_p=600),
    "amplitude.amplitude_factor": lambda m: m["amp"].amplitude_factor(
        DEGS[:1], _polyline(), *_prof(), 600.0, n_p=600),
    "iasp91.iasp91_velocity": lambda m: [
        m["iasp"].iasp91_velocity(np.linspace(0.0, R, 97), w)
        for w in ("Vp", "Vs")],
    "iasp91.generate_iasp91_table": lambda m: m["iasp"]
    .generate_iasp91_table(),
    "interpolation.bilinear": lambda m: m["interp"].bilinear(
        *_quad()[:2], np.array([0.15, 0.4]), np.array([1.5, 4.0]),
        _quad()[2]),
    "interpolation.barycentric_coordinates": lambda m: m["interp"]
    .barycentric_coordinates(np.array([[0.0, 1.0, 0.0]]),
                             np.array([[0.0, 0.0, 1.0]]),
                             np.array([0.2, 1 / 3]), np.array([0.7, 1 / 3])),
    "interpolation.interpolate_elementwise": lambda m: m["interp"]
    .interpolate_elementwise(2.0 + 0.001 * _tiny().r, _tiny()),
}


def _radial_model(flat):
    mdl = flat.RadialModel(*_prof())
    return [mdl.first_arrival(DEGS, n_p=200, diff_radii=(3479.5,),
                              return_p=True),
            mdl.reflected(DEGS, 3479.5, n_p=200),
            mdl.spreading(DEGS, n_p=200, diff_radii=(3479.5,))]


def _tiny():
    gr, _, _ = pt.init_annulus(16, 6, spacing=200.0)
    return gr


def _flat(x):
    """A result as a list of arrays (tuples, dataclasses and lists
    flattened)."""
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in _flat(x[k])]
    if hasattr(x, "__dataclass_fields__"):
        return [np.asarray(getattr(x, k)) for k in x.__dataclass_fields__]
    return [np.asarray(x)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_original(case):
    got, want = _flat(CASES[case](PORT)), _flat(CASES[case](JAX))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, case
        assert np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"), case


def test_generated_iasp91_table_equals_the_vendored_file(tmp_path):
    """The copy generates exactly the port's vendored table, and writes
    it under the port's own data/."""
    from raytracer_tpu_torch.models import velocity

    path = os.path.join(velocity._DATA_DIR, "R_Vp_Vs_IASP91.txt")
    with open(path) as f:
        vendored = f.read()
    p_iasp.generate_iasp91_table(str(tmp_path / "iasp91.txt"))
    with open(tmp_path / "iasp91.txt") as f:
        assert f.read() == vendored
    # regenerate_vendored_table's target is the port's file
    assert os.path.dirname(os.path.dirname(p_iasp.__file__)) == \
        os.path.dirname(velocity._DATA_DIR)


def test_spreading_constant_velocity_is_chord():
    """The JAX package's analytic anchor on the port: straight rays."""
    r = np.linspace(100.0, R, 400)
    v = np.full_like(r, 10.0)
    deltas = np.array([20.0, 60.0, 100.0, 150.0])
    Rg = pt.geometrical_spreading(deltas, r, v)
    chord = 2.0 * R * np.sin(np.deg2rad(deltas) / 2.0)
    assert np.allclose(Rg, chord, rtol=1e-2)
    Rf = pt.RadialModel(r, v).spreading(deltas, n_p=1000)
    assert np.allclose(Rf, chord, rtol=1e-2)


def test_tstar_constant_model_vertical_path():
    depth, v, q = 1000.0, 8.0, 500.0
    rr = np.linspace(R - depth, R, 200)
    pts = np.stack([np.zeros_like(rr), rr], axis=1)
    ts = pt.tstar(pts, np.linspace(1000.0, R, 50), np.full(50, v), q)
    assert np.isclose(ts, depth / (v * q), rtol=1e-12)


def _read_csv(path):
    with open(path) as f:
        rows = [r for r in csv.reader(f)
                if r and not r[0].startswith(("#", "deg"))]
    with open(path) as f:
        header = f.readline().strip()
    return header, np.array([[float(v) for v in r] for r in rows])


@pytest.fixture(scope="module")
def jax_columns():
    """The JAX package's spreading (CMB-diffracted) and PcP/P ratio (Q
    600, 2 Hz) over the receiver fan, with the model they come from, at
    600 ray parameters (the CLI asks for 8000 and the spy below answers
    with these: the CSV's columns are what is checked)."""
    degs = p_main.receiver_degrees()
    dd = np.minimum(degs, 360.0 - degs)
    prof = rt.velocity_profile("ak135")
    Rg = j_flat.RadialModel(prof.r, prof.Vp).spreading(
        dd, n_p=600, diff_radii=(j_flat.cmb_radius("ak135"),))
    pcp = j_zoep.pcp_p_amplitude_ratio(dd, q_factor=600.0, freq_hz=2.0,
                                       n_p=600)
    return degs, Rg, pcp, j_flat.RadialModel(prof.r, prof.Vp)


def _spy_cli(monkeypatch, jax_columns):
    """Record what `main_annulus` hands `write_amplitude`, and answer the
    CLI's spreading and PcP calls with the JAX package's values once
    their arguments are checked equal to the JAX driver's: at 8000 ray
    parameters each takes ~5 s of host NumPy, test_copy_equals_original
    holds both copies to their originals, and chip_smoke.py phase 21
    holds the card's CSV at the full 8000 to the JAX CLI's."""
    seen = {}
    plain = p_main.write_amplitude
    degs, Rg, pcp, model = jax_columns
    dd = np.minimum(degs, 360.0 - degs)

    def spy(args, gr, paths, degs, pts_bent=None):
        seen.update(gr=gr, paths=paths, degs=degs, bent=pts_bent)
        return plain(args, gr, paths, degs, pts_bent)

    def spreading(self, d, n_p, diff_radii):
        for k, v in vars(model).items():
            np.testing.assert_array_equal(getattr(self, k), v)
        np.testing.assert_array_equal(d, dd)
        assert n_p == 8000 and diff_radii == (p_flat.cmb_radius("ak135"),)
        seen["spreading"] = True
        return Rg

    def pcp_ratio(d, model, q_factor, freq_hz):
        np.testing.assert_array_equal(d, dd)
        assert (model, q_factor, freq_hz) == ("ak135", 600.0, 2.0)
        seen["pcp"] = True
        return pcp

    monkeypatch.setattr(p_main, "write_amplitude", spy)
    monkeypatch.setattr(p_flat.RadialModel, "spreading", spreading)
    monkeypatch.setattr(p_zoep, "pcp_p_amplitude_ratio", pcp_ratio)
    return seen


def _check_columns(tab, lines, jax_columns):
    degs, Rg, pcp, _ = jax_columns
    prof = rt.velocity_profile("ak135")
    ts = np.array([rt.tstar(pl, prof.r, prof.Vp, 600.0) for pl in lines])
    valid = np.isfinite(Rg)
    np.testing.assert_array_equal(tab[:, 0], degs)
    np.testing.assert_array_equal(tab[:, 1], ts)
    np.testing.assert_array_equal(tab[:, 2], np.where(valid, Rg, np.nan))
    np.testing.assert_array_equal(tab[:, 3], np.where(
        valid, rt.attenuation_factor(ts, 2.0) / np.where(valid, Rg, 1.0),
        np.nan))
    np.testing.assert_array_equal(tab[:, 4], pcp)
    np.testing.assert_array_equal(tab[:, 5], valid.astype(float))
    assert (~valid).any() and valid.any()     # the core shadow is NaN
    return ts


def _spm_lines(seen):
    gr = seen["gr"]
    return [np.stack([gr.x[p], gr.z[p]], axis=1) for p in seen["paths"]]


def test_cli_refine_amplitude_columns(tmp_path, monkeypatch, jax_columns):
    """`main_annulus --refine --q 600 --freq 2` at 16x4 on the CPU: the
    JAX driver's header, and every column the JAX functions applied to
    the port's bent polylines (128 vertices each, returned by
    `write_refined`), whose t* differs from the graph backtraces'.  The
    bend is asked for at the JAX driver's defaults and run for 50 of its
    800 steps here: what is checked is which polylines t* follows."""
    seen = _spy_cli(monkeypatch, jax_columns)
    plain = p_refine.refine_paths_batch

    def short_bend(*args, **kw):
        assert len(args) == 3 and "iters" not in kw, (len(args), kw)
        return plain(*args, iters=50, **kw)

    monkeypatch.setattr(p_refine, "refine_paths_batch", short_bend)
    prefix = str(tmp_path / "q")
    p_main.main(["--ntheta", "16", "--nr", "4", "--spacing", "400",
                 "--device", "cpu", "--refine", "--q", "600", "--freq", "2",
                 "--out-prefix", prefix])
    assert seen["spreading"] and seen["pcp"]
    header, tab = _read_csv(f"{prefix}_amplitude.csv")
    assert header == "deg,tstar_s,spreading_km,rel_amp,pcp_p_ratio,valid"
    bent = np.asarray(seen["bent"])
    assert bent.shape == (len(seen["paths"]), 128, 2)
    ts = _check_columns(tab, list(bent), jax_columns)
    prof = rt.velocity_profile("ak135")
    ts_spm = np.array([rt.tstar(pl, prof.r, prof.Vp, 600.0)
                       for pl in _spm_lines(seen)])
    assert np.abs(ts - ts_spm).max() > 1e-6


def test_cli_amplitude_without_refine_follows_graph_paths(
        tmp_path, monkeypatch, jax_columns):
    """Without --refine, t* runs along the graph backtraces."""
    seen = _spy_cli(monkeypatch, jax_columns)
    prefix = str(tmp_path / "q")
    p_main.main(["--ntheta", "16", "--nr", "4", "--spacing", "400",
                 "--device", "cpu", "--q", "600", "--freq", "2",
                 "--out-prefix", prefix])
    assert seen["bent"] is None and seen["spreading"] and seen["pcp"]
    _, tab = _read_csv(f"{prefix}_amplitude.csv")
    _check_columns(tab, _spm_lines(seen), jax_columns)
