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
    package's (engine "xla", mode "hclosure");
  * the kernel's launch planner (`tsweep_plan`: lanes a thread, threads,
    halo, shared bytes, the global route for a column the shared one
    cannot hold, its refusals of malformed tables by name) on the 180x63
    column, and NumPy replays of the kernel's order (the weight rows in
    batches of one kind, step 1 from halo columns, the chain's
    ping-pong, the three rotating columns; on the global route p1 and p2
    read back from the output) equal to `_sweep` and to the JAX
    package's `_sweep`.
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
    # the kernel's shared memory at 180x63 in float64: a pointer and an
    # offset a weight row (264), two chain columns, three columns with 42
    # halo lanes each side
    assert psw.tsweep_smem_bytes(896, 8, 42, 264) == (
        12 * 264 + (2 * 896 + 3 * (896 + 84)) * 8)

def _taps_180x63():
    """The 180x63 column's tap offsets as pack_sweep_tables gives them
    (forward): 85 dc = -1 taps, 75 dc = -2, 84 dc = 0, ten chain spans."""
    gr, cg, _ = pt.init_annulus_circulant(180, 63, 20.0)
    ws = ppack(cg, dtype=np.float32, band_closure=0)
    t, s = psw.pack_sweep_tables(ws, cg, np.float32)
    _, d1, _, d2, _, d0 = psw._tap_groups(t, s, False)
    return s.ML, d1, d2, d0, s.chain_spans


def test_tsweep_plan_at_180x63(monkeypatch):
    """The launch planner at the xla engine's 180x63 column: one lane a
    thread (896 threads); the offsets (85 dc = -1, 75 dc = -2 as they
    are, then 84 dc = 0 steps and the ten chain spans back and forth
    reduced mod 896); a halo of 42 lanes.  A smaller thread cap or a
    wider column takes more lanes a thread; a column whose five columns
    do not fit a block's shared memory (6,000 lanes in float64, 12,000
    in float32), or that 16 lanes a thread do not cover, takes the
    global route, which used to be refused (ROADMAP C.15); only
    malformed tables are refused by name: no dc = -+1 or -+2 tap, or a
    step-1 offset over the column."""
    ML, d1, d2, d0, spans = _taps_180x63()
    assert (ML, len(d1), len(d2), len(d0), len(spans)) == (896, 85, 75, 84, 10)
    p = psw.tsweep_plan(ML, 4, d1, d2, d0, spans, True)
    assert (p.halo, p.lpt, p.threads) == (42, 1, 896)
    assert p.smem == 12 * 264 + (2 * 896 + 3 * (896 + 84)) * 4 == 22096
    assert p.offs[:85].tolist() == list(d1) and p.offs[85:160].tolist() == list(d2)
    assert p.offs[160] == d0[0] % ML and p.offs[160 + 84] == ML - 1
    assert p.offs[-1] == 512 and len(p.offs) == 264
    p64 = psw.tsweep_plan(ML, 8, d1, d2, d0, spans, True)
    assert (p64.lpt, p64.threads, p64.smem) == (1, 896, 41024)
    q = psw.tsweep_plan(ML, 4, d1, d2, d0, spans, False)
    assert (len(q.offs), q.smem) == (160, 22096 - 12 * 104)
    # more lanes a thread: a thread cap, or a wider column
    monkeypatch.setattr(psw, "TSWEEP_THREADS", 448)
    assert psw.tsweep_plan(ML, 4, d1, d2, d0, spans, True)[2:4] == (2, 448)
    monkeypatch.setattr(psw, "TSWEEP_THREADS", 1024)
    p = psw.tsweep_plan(1152, 8, d1, d2, d0, spans, True)
    assert (p.lpt, p.threads, p.smem) == (
        2, 576, 12 * 264 + (2 * 1152 + 3 * (1152 + 84)) * 8)
    assert psw.tsweep_plan(3328, 8, d1, d2, d0, spans, True)[2:4] == (4, 832)
    # over 232448 bytes of shared memory: the global route
    g = psw.tsweep_plan(6000, 8, d1, d2, d0, spans, True)
    assert (g.route, g.lpt, g.threads, g.smem) == ("global", 0, 1024, 0)
    assert g.halo == 42 and g.offs[160] == d0[0] % 6000
    g = psw.tsweep_plan(12000, 4, d1, d2, d0, spans, True)
    assert (g.route, g.lpt, g.threads, g.smem) == ("global", 0, 1024, 0)
    p = psw.tsweep_plan(11000, 4, d1, d2, d0, spans, True)
    assert (p.route, p.lpt, p.threads) == ("shared", 16, 704)
    assert p.smem == 12 * 264 + (2 * 11000 + 3 * 11084) * 4 <= 232448
    # more lanes than 16 a thread cover: the global route too
    monkeypatch.setattr(psw, "TSWEEP_THREADS", 32)
    g = psw.tsweep_plan(ML, 4, d1, d2, d0, spans, True)
    assert (g.route, g.lpt, g.threads) == ("global", 0, 32)
    with pytest.raises(ValueError, match="reaches 42 lanes"):
        psw.tsweep_plan(40, 4, d1, d2, d0, spans, True)
    with pytest.raises(ValueError, match="at least one"):
        psw.tsweep_plan(ML, 4, [], [], d0, spans, True)


def _tsweep_replay(v, tabs, plan, n1, reverse, carry, K):
    """csrc/tsweep.cu replayed in NumPy, one block a source, all lanes of a
    step at once: a column's weight rows in batches of K of one kind
    (step 1's taps, or in-column steps; a batch loaded while the one
    before runs, across column ends: a read checks its batch holds its
    row), step 1 from p1 and p2 kept with halos (no wrap), the commit,
    the in-column steps on two ping-pong columns (offsets reduced mod
    ML), and three rotating halo columns.  Buffers the kernel does not
    read yet are NaN."""
    S_, nt, ML = v.shape
    w_all = np.concatenate(tabs)
    offs, H = plan.offs, plan.halo
    n_t1 = len(tabs[0]) + len(tabs[1])
    assert len(tabs[0]) == n1
    R = len(offs)
    S = R - n_t1
    nb1, nbS = -(-n_t1 // K), -(-S // K)
    batches = ([list(range(b * K, min(n_t1, b * K + K))) for b in range(nb1)]
               + [list(range(n_t1 + b * K, min(R, n_t1 + b * K + K)))
                  for b in range(nbS)])
    lane = np.arange(ML)
    out = np.full_like(v, np.nan)

    def col(k):
        return nt - 1 - k if reverse else k

    def halo(x):
        return np.concatenate([x[ML - H:], x, x[:H]])

    for s in range(S_):
        P = [halo(carry[0][s] if carry else v[s, col(nt - 1)]),
             halo(carry[1][s] if carry else v[s, col(nt - 2)]),
             np.full(ML + 2 * H, np.nan, v.dtype)]
        A = np.full(ML, np.nan, v.dtype)
        r = v[s, col(0)].copy()
        cur = {i: w_all[i] for i in batches[0]}
        for k in range(nt):
            p1, p2, pn = P
            for b, rows in enumerate(batches):
                last = b + 1 == len(batches)
                nxt = ({} if last and k + 1 == nt else
                       {i: w_all[i] for i in batches[0 if last else b + 1]})
                for i in rows:
                    w = cur.pop(i)
                    if i < n_t1:
                        r = np.minimum(r, (p1 if i < n1 else p2)
                                       [H + lane + offs[i]] + w)
                    else:
                        assert 0 <= offs[i] < ML
                        r = np.minimum(r, A[(lane + offs[i]) % ML] + w)
                        if i + 1 < R:
                            A = r.copy()
                        else:
                            pn[:] = halo(r)
                    if i + 1 == n_t1:
                        if S:
                            A = r.copy()
                        else:
                            pn[:] = halo(r)
                assert not cur
                cur = nxt
            out[s, col(k)] = r
            if k + 1 < nt:
                r = v[s, col(k + 1)].copy()
            p2[:] = np.nan
            P = [pn, p1, p2]
    return out


_JAX_SWEEPS: dict = {}


@pytest.mark.parametrize("lpt", [1, 4])
@pytest.mark.parametrize("with_carry", [False, True], ids=["wrap", "carry"])
@pytest.mark.parametrize("col_relax", [True, False])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_tsweep_replay_equals_twin(monkeypatch, tables, reverse, col_relax,
                                   with_carry, lpt):
    """The kernel's order of updates, replayed on its own plan (one and
    four lanes a thread: batches of 8 and 2 weight rows), equals `_sweep`
    and the JAX package's `_sweep` bit for bit, in float64 and
    float32."""
    T = tables
    s = T["s"]
    g1_w, g1_d, g2_w, g2_d, w0, d0 = psw._tap_groups(T["t"], s, reverse)
    monkeypatch.setattr(psw, "TSWEEP_THREADS", s.ML // lpt)
    plan = psw.tsweep_plan(s.ML, T["v"].itemsize, g1_d, g2_d, d0,
                           s.chain_spans, col_relax)
    assert plan.lpt == lpt and plan.halo < s.ML
    ci = T["carry"] if with_carry else None
    tabs = [a.numpy() for a in (g1_w, g2_w, w0, T["t"].cfp, T["t"].cbp)]
    if not col_relax:
        tabs = tabs[:2]
    got = _tsweep_replay(T["v"], tabs, plan, len(g1_d), reverse, ci,
                         max(1, 8 // lpt))
    want = psw._sweep(torch.from_numpy(T["v"]), T["t"], s, reverse,
                      col_relax, None if ci is None
                      else tuple(map(torch.from_numpy, ci))).numpy()
    np.testing.assert_array_equal(got, want)
    key = (T["dt"], reverse, col_relax, with_carry)
    if key not in _JAX_SWEEPS:
        _JAX_SWEEPS[key] = np.asarray(jsw._sweep(
            jnp.asarray(T["v"]), T["jt"], T["js"], reverse, col_relax,
            None if ci is None else tuple(map(jnp.asarray, ci))))
    np.testing.assert_array_equal(got, _JAX_SWEEPS[key])


def _tsweep_global_replay(v, tabs, offs, n1, n2, reverse, carry):
    """csrc/tsweep.cu's global route in NumPy, one block a source: p1 and
    p2 the output's last two columns (before the first two, the carry or
    the field's own wrap columns), step 1 with its offsets wrapped by a
    compare each way, the in-column steps ping-ponging between two
    scratch columns (NaN at first: a stale read shows), the last one
    into the output."""
    S, nt, ML = v.shape
    w1, w2 = tabs[0], tabs[1]
    steps = np.concatenate(tabs[2:]) if len(tabs) > 2 else np.zeros((0, ML))
    out = np.full_like(v, np.nan)
    m = np.arange(ML)
    for s in range(S):
        order = list(range(nt))[::-1] if reverse else list(range(nt))
        src1 = carry[0][s] if carry else v[s, order[-1]]
        src2 = carry[1][s] if carry else v[s, order[-2]]
        a = np.full(ML, np.nan, v.dtype)
        b = np.full(ML, np.nan, v.dtype)
        for k, c in enumerate(order):
            p1 = out[s, order[k - 1]] if k >= 1 else src1
            p2 = out[s, order[k - 2]] if k >= 2 else (src1 if k == 1
                                                       else src2)
            r = v[s, c].copy()
            for i in range(n1 + n2):
                j = m + offs[i]
                j = np.where(j < 0, j + ML, np.where(j >= ML, j - ML, j))
                src, w = (p1, w1[i]) if i < n1 else (p2, w2[i - n1])
                r = np.minimum(r, src[j] + w)
            if not len(steps):
                out[s, c] = r
                continue
            a[:] = r
            x, y = a, b
            for t in range(len(steps)):
                j = m + offs[n1 + n2 + t]
                j = np.where(j >= ML, j - ML, j)
                new = np.minimum(x, x[j] + steps[t])
                if t + 1 == len(steps):
                    out[s, c] = new
                else:
                    y[:] = new
                    x, y = y, x
    return out


@pytest.mark.parametrize("with_carry", [False, True], ids=["wrap", "carry"])
@pytest.mark.parametrize("col_relax", [True, False])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_tsweep_global_replay_equals_twin(tables, reverse, col_relax,
                                          with_carry):
    """The global route's order of updates equals `_sweep` bit for bit,
    in float64 and float32, at 48x12 and on a column three times as wide
    (the weight rows' lanes repeated)."""
    T = tables
    for reps in (1, 3):
        t, s = T["t"], T["s"]
        if reps > 1:
            t = t._replace(wg=tuple(a.repeat(1, reps) for a in t.wg),
                           cfp=t.cfp.repeat(1, reps),
                           cbp=t.cbp.repeat(1, reps))
            s = s._replace(ML=s.ML * reps)
        g1_w, g1_d, g2_w, g2_d, w0, d0 = psw._tap_groups(t, s, reverse)
        plan = psw.tsweep_plan(s.ML, T["v"].itemsize, g1_d, g2_d, d0,
                               s.chain_spans, col_relax)
        v = np.tile(T["v"], (1, 1, reps))
        ci = (tuple(np.tile(c, (1, reps)) for c in T["carry"])
              if with_carry else None)
        tabs = [a.numpy() for a in (g1_w, g2_w, w0, t.cfp, t.cbp)]
        if not col_relax:
            tabs = tabs[:2]
        got = _tsweep_global_replay(v, tabs, plan.offs, len(g1_d),
                                    len(g2_d), reverse, ci)
        want = psw._sweep(torch.from_numpy(v), t, s, reverse, col_relax,
                          None if ci is None
                          else tuple(map(torch.from_numpy, ci))).numpy()
        np.testing.assert_array_equal(got, want)
