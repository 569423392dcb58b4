"""The hand-written free-gas and CM-continuum kernels: their plain versions on
the CPU, the premises their designs rest on, and their wrappers' checks.

The CUDA kernels (csrc/freegas_sab.cu, csrc/cm_pointwise.cu) run only on a
card; on the CPU each wrapper takes its plain torch version. So here:

  - cm_moments_pointwise, which now reaches the inner integral through
    cm_inner_moments (cm_inner_moments_ref on the CPU), still equals the JAX
    cm_moments_pointwise on every variant, split into two outer chunks:
    |got - ref| <= 1e-14 + 1e-12 * (the row's largest |moment|) (both are
    float64 with the same formulas; they differ by the ulps of exp, expm1
    and pow and by summation order);
  - sab_density on the CPU is _sab_dens times 2y, bit for bit;
  - the kernels' edge walks give the plain versions' edges: the two-way
    merge of the clipped free-gas u-ladders equals torch.sort of their
    concatenation, and the CM tabular path's crossing roots, four runs
    monotone in mu merged with the clipped knots, give torch.sort's multiset
    for any number of mu knots, at outer nodes on both sides of s;
  - each wrapper refuses what its kernel does not take, and the CPU path
    never counts a launch;
  - the premises of the redesigned kernels' arithmetic: numpy emulations of
    the free-gas node's rsqrt form (t = u + d r, jac = 1 + u r with
    r = rsqrt(u^2 + c)) and its table form exp(-u^2) exp(-bpos) match the
    plain formulas, edge cases included; the fixed-ladder table's u-nodes and
    weights are the plain version's on every table panel of the thermal
    tile, bit for bit; the CM node's hoisted reciprocals keep the plain
    version's table cells and match its divisions; the lanes per point that
    the wrappers choose are the ones scripts/torch_profile_deck.py --plan
    reports for the decks' tiles.

The tests marked cuda hold each kernel against its plain version on the card
(python -m pytest --noconftest -m cuda tests/test_torch_hand_kernels.py); the
card's machine has no jax, so only the reference test imports it.
"""

import numpy as np
import pytest
import torch

from ndpp_tpu_torch.ops import continuum as t_cont
from ndpp_tpu_torch.ops import freegas as t_fg
from ndpp_tpu_torch.ops.legendre import gl_nodes_weights

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ORDER = 3
KT = 0.0253
AWR = 200.0  # heavy: narrow y-windows, so the knot window of 4 is valid


def _t(x):
    return None if x is None else torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64)


def _bounds(ng):
    return np.geomspace(1e3, 2e7, ng + 1)


def _cm_inputs(seed, t, k_real=13, ke=16, kmu=5):
    """Seeded CM-law rows (the recipe of test_torch_continuum_ops._cm_inputs):
    E'_cm knots in [0.3, 0.9] of the incident energy, edge-padded from k_real
    to ke. The Kalbach r and a rows and the mu table also come on the N-body
    knot ladder (NBODY_KNOTS columns; r and a a constant per row: the
    ladder's 0.25^12 steps would extrapolate a varying a to overflow in the
    plain version's dead panels)."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(2e6, 1.5e7, size=t)
    jitter = 0.15 * 0.6 / (k_real - 1)
    kn = np.sort(np.linspace(0.3, 0.9, k_real)[None, :] + rng.uniform(-jitter, jitter, size=(t, k_real)), axis=1)
    kn = kn * e[:, None]
    pdf = rng.uniform(0.2, 1.0, size=(t, k_real))
    pdf[:, 0] = pdf[:, -1] = 0.0
    pdf /= np.sum(0.5 * (pdf[:, 1:] + pdf[:, :-1]) * np.diff(kn, axis=1), axis=1, keepdims=True)
    rr = rng.uniform(0.0, 1.0, size=(t, k_real))
    aa = rng.uniform(0.0, 3.0, size=(t, k_real))
    aa[:, 0] = 1e-12  # the isotropic limit the expm1 form is for
    mu_knots = np.concatenate([[-1.0], np.sort(rng.uniform(-0.9, 0.9, size=kmu - 2)), [1.0]])
    mup = rng.uniform(0.2, 1.0, size=(t, k_real, kmu))
    pad = lambda a: np.pad(a, [(0, 0), (0, ke - k_real)] + [(0, 0)] * (a.ndim - 2), mode="edge")  # noqa: E731
    nb = t_cont.NBODY_KNOTS
    return dict(e=e, kn=pad(kn), pd=pad(pdf), rr=pad(rr), aa=pad(aa), muk=mu_knots, mup=pad(mup), emax=0.8 * e,
                rr_nb=np.repeat(rr[:, 1:2], nb, axis=1), aa_nb=np.repeat(aa[:, 1:2], nb, axis=1),
                mup_nb=np.pad(mup, [(0, 0), (0, nb - k_real), (0, 0)], mode="edge"))


def _cm_port(d, angular, energy, ksel, chunk, nq=4):
    """cm_moments_pointwise of the port on the inputs d (lagrange split, 12
    groups, cross_edges with tabular angles)."""
    nbody, kal, tab = energy == "nbody", angular == "kalbach", angular == "tabular"
    rr, aa, mup = (d["rr_nb"], d["aa_nb"], d["mup_nb"]) if nbody else (d["rr"], d["aa"], d["mup"])
    return t_cont.cm_moments_pointwise(
        _t(d["e"]), None if nbody else _t(d["kn"]), None if nbody else _t(d["pd"]),
        _t(rr) if kal else None, _t(aa) if kal else None,
        _t(d["muk"]) if tab else None, _t(mup) if tab else None, _t(d["emax"]) if nbody else None,
        0.5, _t(_bounds(12)), AWR, ORDER, nq, nq, angular, energy, True, chunk, ksel, "lagrange", tab,
    )


def _row_close(got, ref, rtol=1e-12, atol=1e-14):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    bad = np.abs(got - ref) > atol + rtol * scale
    assert not bad.any(), f"{int(bad.sum())} elements differ, worst {np.abs(got - ref).max():.3e}"


# (angular, energy, ksel, cross_edges): every angular law, both energies, the knot window
CM_VARIANTS = [
    ("kalbach", "tabular", 4, False),
    ("tabular", "tabular", 0, True),
    ("isotropic", "tabular", 4, False),
    ("isotropic", "nbody", 0, False),
]


@pytest.mark.parametrize("variant", CM_VARIANTS, ids=["-".join(map(str, v)) for v in CM_VARIANTS])
def test_cm_inner_ref_composes_to_the_reference(variant):
    from ndpp_tpu.ops import continuum as j_cont

    angular, energy, ksel, cross = variant
    d = _cm_inputs(seed=11, t=8)
    ke = t_cont.NBODY_KNOTS if energy == "nbody" else d["kn"].shape[1]
    kmu = d["muk"].size if angular == "tabular" else 0
    npan = t_cont.outer_panel_count(ke, 12, angular, kmu, "lagrange", cross)
    got = _cm_port(d, angular, energy, ksel, chunk=-(-npan // 2))  # two outer chunks on the plain path
    ref = j_cont.cm_moments_pointwise(
        d["e"], d["kn"], d["pd"], d["rr"], d["aa"], d["muk"], d["mup"], d["emax"], 0.5, _bounds(12), AWR,
        ORDER, 4, 4, angular, energy, True, 8, ksel, "lagrange", cross,
    )
    assert np.abs(np.asarray(ref)).max() > 0
    _row_close(got.numpy(), ref)


def _cm_operands(angular="kalbach", energy="tabular", ksel=0, t=4):
    """The operands cm_moments_pointwise hands the wrapper, captured from a
    small call: (args, chunk)."""
    d = _cm_inputs(seed=5, t=t)
    seen = {}
    real = t_cont.cm_inner_moments

    def capture(*args, chunk=None, lanes=None):
        seen["call"] = (args, chunk)
        return real(*args, chunk=chunk, lanes=lanes)

    t_cont.cm_inner_moments = capture
    try:
        _cm_port(d, angular, energy, ksel, chunk=8)
    finally:
        t_cont.cm_inner_moments = real
    return seen["call"]


def test_cm_inner_chunks_do_not_change_the_result():
    args, _ = _cm_operands("kalbach", "tabular", 4, t=2)
    whole = t_cont.cm_inner_moments_ref(*args)
    for chunk in (37, 100, args[0].shape[1] - 1):
        torch.testing.assert_close(t_cont.cm_inner_moments(*args, chunk=chunk), whole, rtol=0, atol=0)


def _sab_operands(awr=15.858, rows=4, order=ORDER):
    """(pmid, phalf, v, awr, kt) of a freegas_moments_sab call on the CPU."""
    e = torch.as_tensor(np.geomspace(1e-3, 2.0, rows))
    seen = {}
    real = t_fg.sab_density

    def capture(pm, ph, v, a, k, order, chunk=t_fg.Y_PANELS, lanes=None):
        seen["args"] = (pm, ph, v, a, k)
        return real(pm, ph, v, a, k, order, chunk, lanes)

    t_fg.sab_density = capture
    try:
        t_fg.freegas_moments_sab(e, awr, KT, torch.as_tensor(np.concatenate([[0.0], np.geomspace(1e-4, 20.0, 17)])), order)
    finally:
        t_fg.sab_density = real
    return seen["args"]


def test_sab_density_on_the_cpu_is_the_plain_density_times_2y():
    pm, ph, v, awr, kt = _sab_operands()
    before = t_fg.sab_density.launches
    got = t_fg.sab_density(pm, ph, v, awr, kt, ORDER, chunk=5)
    assert t_fg.sab_density.launches == before == 0
    xg = torch.as_tensor(gl_nodes_weights(t_fg.NQ_G)[0])
    y = (pm[:, :, None] + ph[:, :, None] * xg).reshape(pm.shape[0], -1)
    want = torch.stack(t_fg._sab_dens(y, v, awr, kt, ORDER), dim=-1) * (2.0 * y)[..., None]
    assert got.shape == (pm.shape[0], pm.shape[1], t_fg.NQ_G, ORDER + 1)
    assert torch.equal(got.reshape(want.shape), want)


def test_freegas_ladder_merge_equals_the_sort():
    """The kernel's walk: lo, then the smaller head of the two clipped
    ladders at each step, then hi: torch.sort's edges, on random points."""
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.uniform(1e-3, 3.0, size=(3, 50)))
    e = torch.as_tensor(rng.uniform(1e-3, 3.0, size=3))
    v, awr, kt = torch.sqrt(e), torch.full((3,), 15.858), torch.full((3,), KT)
    want, c, _ = t_fg.sab_u_edges(y, v, awr, kt)
    lo, hi = want[..., 0], want[..., -1]
    ulad = [torch.minimum(torch.maximum(torch.full_like(lo, u), lo), hi) for u in t_fg._SAB_ULAD]
    clad = [torch.minimum(torch.maximum(torch.sqrt(c) * u, lo), hi) for u in t_fg._SAB_CLAD]
    for i in range(y.shape[0]):
        for j in range(y.shape[1]):
            a, b, walk = 0, 0, [float(lo[i, j])]
            for _ in range(len(ulad) + len(clad)):
                ua = float(ulad[a][i, j]) if a < len(ulad) else np.inf
                cb = float(clad[b][i, j]) if b < len(clad) else np.inf
                if ua <= cb:
                    walk.append(ua)
                    a += 1
                else:
                    walk.append(cb)
                    b += 1
            walk.append(float(hi[i, j]))
            assert walk == want[i, j].tolist()


def _root_runs(wv, sv, mk, lo, hi):
    """The kernel's RootRuns walk: the 2 KMU clipped crossing roots as four
    runs, each monotone in mu (split where the - branch leaves its rising
    prefix A and where the + branch enters its rising suffix B when
    w^2 < s^2), each walked the way it ascends with its running maximum, and
    merged by their heads."""
    s2, c = sv * sv, wv * wv - sv * sv
    disc = lambda m: s2 * (m * m) + c  # noqa: E731
    ka, kb = 0, len(mk)
    if c < 0.0:
        ka = sum(1 for m in mk if m < 0.0 and disc(m) > 0.0)
        kb = len(mk) - sum(1 for m in mk if m > 0.0 and disc(m) > 0.0)
        assert all(m < 0.0 and disc(m) > 0.0 for m in mk[:ka])  # A is a prefix, B a suffix
        assert all(m > 0.0 and disc(m) > 0.0 for m in mk[kb:])

    def run(ks, sgn):
        out, last = [], -np.inf
        for k in ks:
            last = max(last, min(max(-sv * mk[k] + sgn * np.sqrt(max(disc(mk[k]), 0.0)), lo), hi))
            out.append(last)
        return out

    runs = [run(range(kb - 1, -1, -1), 1.0), run(range(kb, len(mk)), 1.0),
            run(range(ka), -1.0), run(range(len(mk) - 1, ka - 1, -1), -1.0)]
    heads, walk = [0] * 4, []
    while True:
        live = [(r[h], j) for j, (r, h) in enumerate(zip(runs, heads)) if h < len(r)]
        if not live:
            return walk
        v, j = min(live)
        walk.append(v)
        heads[j] += 1


def _knot_root_walk(knots, roots, lo, hi):
    """lo, the smaller head of the clipped knots and the sorted roots at each step, hi."""
    a, b, walk = 0, 0, [lo]
    while a < len(knots) or b < len(roots):
        if b >= len(roots) or (a < len(knots) and knots[a] <= roots[b]):
            walk.append(knots[a])
            a += 1
        else:
            walk.append(roots[b])
            b += 1
    return walk + [hi]


def test_cm_tabular_root_sort_and_merge_give_the_sorted_multiset():
    """The kernel's tabular edges on a captured tile: the clipped roots of
    the four monotone runs, merged with the clipped knot stream between lo
    and hi: the multiset torch.sort gives."""
    args, _ = _cm_operands("tabular", "tabular", 4, t=3)
    w, s, yk, mu_knots = args[0], args[1], args[2], args[5]
    ke, nsel = yk.shape[1], 4
    want, ok_w, j0, yk_sel = t_cont.cm_inner_edges(w, s, yk, mu_knots, nsel)
    mk = mu_knots.tolist()
    checked = 0
    for t in range(w.shape[0]):
        for i in range(0, w.shape[1], 7):
            if not ok_w[t, i]:
                continue
            wv, sv = float(w[t, i]), float(s[t])
            lo, hi = max(abs(wv - sv), float(yk[t, 0])), min(wv + sv, float(yk[t, -1]))
            knots = [min(max(float(x), lo), hi) for x in yk_sel[t, i]]
            walk = _knot_root_walk(knots, _root_runs(wv, sv, mk, lo, hi), lo, hi)
            np.testing.assert_allclose(walk, want[t, i].tolist(), rtol=0, atol=1e-12 * hi)
            checked += 1
    assert checked > 10 and ke > nsel


def _cm_check_operands(t, nw, ke, kmu, seed, device="cpu"):
    """Tabular-energy, tabular-angle operands beyond the fixtures (the
    recipe of chip_smoke.cm_check_tile): A = 1, so s = sqrt(E)/2 and the
    outer nodes fall on both sides of s; KMU mu knots with 0 among them."""
    rng = np.random.default_rng(seed)
    ek = np.sort(rng.uniform(0.05, 0.9, size=(t, ke)), axis=1)
    pdf = rng.uniform(0.2, 1.0, size=(t, ke))
    slope = np.diff(pdf, axis=1) / np.diff(ek, axis=1)
    payload = np.stack([pdf[:, :-1] - slope * ek[:, :-1], slope], axis=-1)
    muk = np.unique(np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1.0, 1.0, size=kmu - 3)]))
    assert muk.size == kmu
    w = np.sort(rng.uniform(0.01, np.sqrt(0.9) + 0.5, size=(t, nw)), axis=1)
    put = lambda a: _t(a).to(device)  # noqa: E731
    return (put(w), put(np.full(t, 0.5)), put(np.sqrt(ek)), put(ek), put(payload), put(muk),
            put(rng.uniform(0.2, 1.0, size=(t, ke, kmu))), None, None, 0.0, ORDER, 4, "tabular", "tabular", 0)


def test_cm_root_runs_merge_any_number_of_mu_knots():
    """The four-run walk gives the sorted roots for 200 mu knots, at outer
    nodes on both sides of s (w < s puts a turning point in each branch)."""
    args = _cm_check_operands(2, 40, 8, 200, seed=2)
    w, s, yk, mu_knots = args[0], args[1], args[2], args[5]
    want, ok_w, _, _ = t_cont.cm_inner_edges(w, s, yk, mu_knots, yk.shape[1])
    mk = mu_knots.tolist()
    below = 0
    for t in range(w.shape[0]):
        for i in range(w.shape[1]):
            if not ok_w[t, i]:
                continue
            wv, sv = float(w[t, i]), float(s[t])
            below += wv < sv
            lo, hi = max(abs(wv - sv), float(yk[t, 0])), min(wv + sv, float(yk[t, -1]))
            knots = [min(max(float(x), lo), hi) for x in yk[t]]
            walk = _knot_root_walk(knots, _root_runs(wv, sv, mk, lo, hi), lo, hi)
            np.testing.assert_allclose(walk, want[t, i].tolist(), rtol=0, atol=1e-12 * hi)
    assert 10 < below < int(ok_w.sum()) - 10


def test_wrappers_refuse_what_the_kernels_do_not_take():
    pm, ph, v, awr, kt = _sab_operands()
    with pytest.raises(TypeError, match="float64"):
        t_fg.sab_density(pm.float(), ph, v, awr, kt, ORDER)
    with pytest.raises(ValueError, match="order"):
        t_fg.sab_density(pm, ph, v, awr, kt, 11)
    with pytest.raises(ValueError, match="order"):
        t_fg.sab_density(pm, ph, v, awr, kt, -1)
    with pytest.raises(ValueError, match="shape"):
        t_fg.sab_density(pm, ph[:, :-1], v, awr, kt, ORDER)
    with pytest.raises(ValueError, match="kt"):
        t_fg.sab_density(pm, ph, v, awr, kt[:-1], ORDER)
    with pytest.raises(ValueError, match="contiguous"):
        t_fg.sab_density(pm.t().contiguous().t(), ph, v, awr, kt, ORDER)
    meta = [x.to("meta") for x in (pm, ph, v, awr, kt)]
    with pytest.raises(ValueError, match="unsupported device"):
        t_fg.sab_density(*meta, ORDER)

    args, _ = _cm_operands("kalbach", "tabular", 4)
    with pytest.raises(TypeError, match="float64"):
        t_cont.cm_inner_moments(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="order"):
        t_cont.cm_inner_moments(*args[:10], 11, *args[11:])
    with pytest.raises(ValueError, match="payload"):
        t_cont.cm_inner_moments(*args[:4], args[4][:, :, :2].contiguous(), *args[5:])
    with pytest.raises(ValueError, match="contiguous"):
        t_cont.cm_inner_moments(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="angular"):
        t_cont.cm_inner_moments(*args[:12], "anisotropic", *args[13:])
    with pytest.raises(ValueError, match="mu_knots"):  # tabular angles need their mu table
        t_cont.cm_inner_moments(*args[:12], "tabular", *args[13:])
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in args]
    with pytest.raises(ValueError, match="unsupported device"):
        t_cont.cm_inner_moments(*meta)


def test_cpu_calls_never_count_a_launch():
    t_fg.sab_density.launches = t_cont.cm_inner_moments.launches = 0
    e, window = torch.tensor([0.01, 0.1], dtype=torch.float64), torch.tensor([0.0, 1e-3, 1.0, 10.0], dtype=torch.float64)
    t_fg.freegas_moments_sab(e, 1.0, KT, window, 1)
    args, chunk = _cm_operands("isotropic", "nbody", 0, t=2)
    t_cont.cm_inner_moments(*args, chunk=chunk)
    assert t_fg.sab_density.launches == t_cont.cm_inner_moments.launches == 0
    assert not t_fg.sab_density.launches_by_stream and not t_cont.cm_inner_moments.launches_by_stream


def _fma(a, b, c):
    """a * b + c with one rounding (through long double, as the kernels' fma)."""
    return np.asarray(np.longdouble(a) * np.longdouble(b) + np.longdouble(c), dtype=np.float64)


def _rsqrt_normal(x):
    """The kernels' rsqrt_normal: an approximation good to ~2^-22 (as
    rsqrt.approx.f64), then one third-order correction."""
    r = (1.0 / np.sqrt(x)) * (1.0 + 2.0**-22)
    e = _fma(-x, r * r, 1.0)
    return _fma(_fma(0.375, e, 0.5), r * e, r)


def _rcp_normal(x):
    """The CM kernel's rcp_normal: ~2^-22 (as rcp.approx.f64), then one
    third-order correction."""
    r = (1.0 / x) * (1.0 - 2.0**-22)
    e = _fma(-x, r, 1.0)
    return _fma(r, _fma(e, e, e), r)


@pytest.mark.parametrize("case", ["random", "c0-u-negative", "u0-c0", "bpos-large"])
def test_freegas_rsqrt_and_table_forms_match_the_plain_node(case):
    """csrc/freegas_sab.cu's node, emulated: t = u + d r, jac = 1 + u r with
    r = rsqrt_normal(d), d = u^2 + c (sqrt(d) floored at 1e-30 below
    d = 1e-60, as the plain version floors it), and the weight's exponential
    as exp(-u^2) exp(-bpos) (the table form), against the plain formulas
    t = u + sqrt(d), jac = t / max(sqrt(d), 1e-30), exp(-u^2 - bpos): within
    1e-13 of each quantity's scale."""
    rng = np.random.default_rng(17)
    u = rng.uniform(-8.5, 8.5, size=4000)
    c = rng.uniform(0.0, 50.0, size=4000)
    bpos = rng.uniform(0.0, 30.0, size=4000)
    if case == "c0-u-negative":
        c[:] = 0.0
        u = -np.abs(u)
    elif case == "u0-c0":
        u[::2], c[::2] = 0.0, 0.0
        c[1::2] = 0.0
    elif case == "bpos-large":
        bpos = rng.uniform(300.0, 600.0, size=4000)
    d = _fma(u, u, c)
    r = np.where(d > 0, _rsqrt_normal(np.where(d > 0, d, 1.0)), np.inf)
    with np.errstate(invalid="ignore"):  # 0 x inf where d = 0, replaced below as in the kernel
        t = _fma(d, r, u)
        jac = _fma(u, r, 1.0)
    low = d < 1e-60
    t = np.where(low, u + np.sqrt(d), t)
    jac = np.where(low, t * 1e30, jac)
    expo_k = np.exp(-(u * u)) * np.exp(-bpos)
    root = np.sqrt(u * u + c)
    t_p = u + root
    jac_p = t_p / np.maximum(root, 1e-30)
    expo_p = np.exp(-(u * u) - bpos)
    assert np.isfinite(t).all() and np.isfinite(jac).all()
    np.testing.assert_allclose(t, t_p, rtol=0, atol=1e-13 * np.max(np.abs(u) + root))
    np.testing.assert_allclose(jac, jac_p, rtol=0, atol=1e-13)
    np.testing.assert_allclose(expo_k, expo_p, rtol=1e-13, atol=0)
    if case != "random":
        assert low.any() == (case == "u0-c0") and (jac[low] == 0.0).all()


def test_freegas_table_nodes_are_the_plain_nodes_bit_for_bit():
    """On the thermal tile's y-nodes (h1 rows below 400 kT at 293.6 K, 32
    of them here), every live u-panel of sab_u_edges whose edges are two
    consecutive _SAB_ULAD values has the plain version's nodes u = pm + ph x_q
    and weights ph w_q equal to sab_ulad_table's row for it, bit for bit; such
    panels are about half of the live ones."""
    import chip_smoke

    e, awr, kt, window = chip_smoke.freegas_inputs("cpu", 32)
    v = torch.sqrt(e)
    a_r, k_r = t_fg._per_row(awr, e), t_fg._per_row(kt, e)
    seen = {}

    def gvals(pm, ph):  # capture the y-panels; the density itself is not needed
        seen.update(pm=pm, ph=ph)
        return pm.new_zeros(pm.shape + (t_fg.NQ_G, 1))

    t_fg._outgoing_panelsplit(e, v, a_r, k_r, window, 0, t_fg.NQ_G, t_fg.NFILL_Y, gvals)
    xg = torch.as_tensor(gl_nodes_weights(t_fg.NQ_G)[0])
    y = (seen["pm"][:, :, None] + seen["ph"][:, :, None] * xg).reshape(e.shape[0], -1)
    edges = t_fg.sab_u_edges(y, v, a_r, k_r)[0].numpy()
    e0, e1 = edges[..., :-1], edges[..., 1:]
    ulad = t_fg._SAB_ULAD
    k = np.clip(np.searchsorted(ulad, e0), 0, ulad.size - 2)
    table = (e1 > e0) & (ulad[k] == e0) & (ulad[k + 1] == e1)
    xq, wq = (torch.as_tensor(a) for a in gl_nodes_weights(t_fg.NQ_U))
    pm, ph = torch.as_tensor(0.5 * (e1 + e0))[table], torch.as_tensor(0.5 * (e1 - e0))[table]
    u = (pm[:, None] + ph[:, None] * xq).numpy()  # _sab_dens's own operations
    w = (ph[:, None] * wq).numpy()
    tab = t_fg.sab_ulad_table()
    assert tab.shape == (3, ulad.size - 1, t_fg.NQ_U)
    np.testing.assert_array_equal(u, tab[0][k[table]])
    np.testing.assert_array_equal(w, tab[1][k[table]])
    np.testing.assert_array_equal(np.exp(-(u * u)), tab[2][k[table]])
    assert 0.4 < table.sum() / (e1 > e0).sum() < 0.7


def test_cm_hoisted_reciprocals_keep_the_cells_and_the_values():
    """csrc/cm_pointwise.cu's node, emulated on the tabular tile's live inner
    panels: mu_lab = (w^2 + s^2 - x) / (2 s w) as a product with the outer
    node's reciprocal, mu_cm with one rcp_normal(max(2 s y, 1e-30)), t_e and t_m
    as products with the panel's reciprocal widths. The table cell of each
    panel (je, jm, chosen from ymid with the division kept) is the plain
    version's, and mu_lab, mu_cm and the bilinear p_mu match the division
    form within 1e-13 of their scale (|mu| <= 1; p_mu: the row's largest)."""
    args, _ = _cm_operands("tabular", "tabular", 0, t=3)
    w, s, yk, e_knots, mu_knots, mu_pdf = (args[i] for i in (0, 1, 2, 3, 5, 6))
    edges, ok_w, _, _ = t_cont.cm_inner_edges(w, s, yk, mu_knots, yk.shape[1])
    xq = gl_nodes_weights(4)[0]
    ek, muk, mup = e_knots.numpy(), mu_knots.numpy(), mu_pdf.numpy()
    checked = 0
    for t in range(w.shape[0]):
        sv = float(s[t])
        for i in range(0, w.shape[1], 3):
            if not ok_w[t, i]:
                continue
            wv = float(w[t, i])
            wms2, wps2 = wv * wv - sv * sv, wv * wv + sv * sv
            lab_den = max(2.0 * sv * wv, 1e-30)
            inv_lab = 1.0 / lab_den
            ed = edges[t, i].numpy()
            for e0, e1 in zip(ed[:-1], ed[1:]):
                if not e1 > e0:
                    continue
                ymid, yhalf = 0.5 * (e1 + e0), 0.5 * (e1 - e0)
                # the cell: the plain version's rule, with its division (the kernel keeps both)
                je = int(np.clip(np.searchsorted(ek[t], ymid * ymid, side="right") - 1, 0, ek.shape[1] - 2))
                mum = np.clip((wms2 - ymid * ymid) / max(2.0 * sv * ymid, 1e-30), -1.0, 1.0)
                jm = int(np.clip(np.searchsorted(muk, mum, side="right") - 1, 0, muk.size - 2))
                je_p = int(t_cont._panel_index_rows(e_knots[t : t + 1], torch.tensor([[ymid * ymid]]))[0, 0])
                jm_p = int(t_cont._panel_index_rows(mu_knots[None, :], torch.tensor([[mum]]))[0, 0])
                assert (je, jm) == (je_p, jm_p)
                ek_w, mk_w = max(ek[t, je + 1] - ek[t, je], 1e-30), max(muk[jm + 1] - muk[jm], 1e-30)
                c00, c01, c10, c11 = mup[t, je, jm], mup[t, je, jm + 1], mup[t, je + 1, jm], mup[t, je + 1, jm + 1]
                y = _fma(yhalf, xq, ymid)
                x = y * y
                lab_k = np.clip((wps2 - x) * inv_lab, -1.0, 1.0)
                lab_p = np.clip((wps2 - x) / lab_den, -1.0, 1.0)
                mu_k = np.clip((wms2 - x) * _rcp_normal(np.maximum(2.0 * sv * y, 1e-30)), -1.0, 1.0)
                mu_p = np.clip((wms2 - x) / np.maximum(2.0 * sv * y, 1e-30), -1.0, 1.0)

                def p_mu(t_e, t_m):
                    lo_mix, hi_mix = c00 + t_m * (c01 - c00), c10 + t_m * (c11 - c10)
                    return lo_mix + t_e * (hi_mix - lo_mix)

                pa_k = p_mu(np.clip((x - ek[t, je]) * (1.0 / ek_w), 0, 1), np.clip((mu_k - muk[jm]) * (1.0 / mk_w), 0, 1))
                pa_p = p_mu(np.clip((x - ek[t, je]) / ek_w, 0, 1), np.clip((mu_p - muk[jm]) / mk_w, 0, 1))
                np.testing.assert_allclose(lab_k, lab_p, rtol=0, atol=1e-13)
                np.testing.assert_allclose(mu_k, mu_p, rtol=0, atol=1e-13)
                np.testing.assert_allclose(pa_k, pa_p, rtol=0, atol=1e-13 * np.abs(mup[t]).max())
                checked += 1
    assert checked > 100


def test_wrappers_choose_the_lanes_the_plan_reports():
    """The lanes per point of sab_density and cm_inner_moments on an H100
    (132 SMs) are the ones torch_profile_deck.py --plan lists, on the decks'
    tile sizes (thermal: free-gas calls of 7-239 rows; continuum: CM calls
    of kalbach 7 and 11, law61cm 15, nbody 1 and 13 rows), and they fill the
    card: G = 1 where a lane per point does, the smallest G that does else,
    8 at most."""
    import importlib.util
    from pathlib import Path

    from ndpp_tpu_torch.ops.lanes import H100_SMS, lane_group

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_profile_deck.py"
    spec = importlib.util.spec_from_file_location("torch_profile_deck", path)
    deck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(deck)
    want = {7: 8, 14: 8, 15: 8, 20: 8, 98: 2, 103: 2, 194: 1, 204: 1, 217: 1, 239: 1, 256: 1}
    for rows, g in want.items():
        assert deck.freegas_tile(rows, 5)["lanes"] == t_fg.sab_lanes(rows, t_fg.Y_PANELS, H100_SMS) == g
    for rows, nw, ke, kmu, ksel, angular, energy, g in [
        (11, 2780, 128, 0, 32, "kalbach", "tabular", 8), (7, 2780, 128, 0, 32, "kalbach", "tabular", 8),
        (16, 2780, 128, 0, 32, "kalbach", "tabular", 4), (15, 18684, 64, 21, 0, "tabular", "tabular", 1),
        (1, 760, 27, 0, 0, "isotropic", "nbody", 8), (13, 760, 27, 0, 0, "isotropic", "nbody", 8),
        (256, 2780, 128, 0, 32, "kalbach", "tabular", 1),
    ]:
        tile = deck.cm_tile(rows, nw, ke, kmu, ksel, 5, angular, energy)
        assert tile["lanes"] == t_cont.cm_lanes(rows, nw, H100_SMS) == g
        assert tile["order_bucket"] == 5 and tile["grid"] == [rows, -(-nw * g // 128)]
    assert [t_cont.cm_order_bucket(o) for o in range(11)] == [3] * 4 + [5] * 2 + [10] * 5
    sizes = [lane_group(n) for n in (1, 10_000, 50_000, 100_000, 200_000)]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] == 8 and sizes[-1] == 1
    with pytest.raises(ValueError, match="lanes"):
        t_fg.sab_density(*_sab_operands(), ORDER, lanes=3)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run python3 chip_smoke.py on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 5, 10])
def test_sab_kernel_matches_plain_version_on_the_card(order):
    _need_card()
    pm, ph, v, awr, kt = (x.cuda() for x in _sab_operands(awr=0.999167, rows=16, order=order))
    before = t_fg.sab_density.launches
    got = t_fg.sab_density(pm, ph, v, awr, kt, order)
    torch.cuda.synchronize()
    assert t_fg.sab_density.launches == before + 1
    _row_close(got.cpu(), t_fg.sab_density_ref(pm, ph, v, awr, kt, order).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [(a, e, k) for a in t_cont.ANGULAR for e in ("tabular", "nbody") for k in (0, 4)])
def test_cm_kernel_matches_plain_version_on_the_card(variant):
    """Every template instance: angular law x energy x knot window."""
    _need_card()
    args, chunk = _cm_operands(*variant)
    args = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
    before = t_cont.cm_inner_moments.launches
    got = t_cont.cm_inner_moments(*args)
    torch.cuda.synchronize()
    assert t_cont.cm_inner_moments.launches == before + 1
    _row_close(got.cpu(), t_cont.cm_inner_moments_ref(*args, chunk=chunk).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 512, 32, 200, "shared"), (16, 256, 512, 64, "l2")],
                         ids=["kmu200-shared", "ke512-kmu64-l2"])
def test_cm_kernel_takes_any_mu_table_on_the_card(shape):
    """200 mu knots (more than any fixed per-thread root array would hold),
    and row tables over 227 KB (KE 512 x KMU 64), which the launch reads
    through L2 and says so."""
    _need_card()
    t, nw, ke, kmu, path = shape
    args = _cm_check_operands(t, nw, ke, kmu, seed=ke + kmu, device="cuda")
    t_cont.cm_inner_moments.row_tables.clear()
    got = t_cont.cm_inner_moments(*args)
    torch.cuda.synchronize()
    assert dict(t_cont.cm_inner_moments.row_tables) == {path: 1}
    _row_close(got.cpu(), t_cont.cm_inner_moments_ref(*args, chunk=64).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_sab_kernel_every_lane_group_matches_plain_version_on_the_card(lanes):
    """Each lane group G, forced, on a tile of 16 rows (whose own choice is 8)."""
    _need_card()
    pm, ph, v, awr, kt = (x.cuda() for x in _sab_operands(awr=0.999167, rows=16, order=5))
    t_fg.sab_density.lane_groups.clear()
    got = t_fg.sab_density(pm, ph, v, awr, kt, 5, lanes=lanes)
    torch.cuda.synchronize()
    assert dict(t_fg.sab_density.lane_groups) == {lanes: 1}
    _row_close(got.cpu(), t_fg.sab_density_ref(pm, ph, v, awr, kt, 5).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", [(a, e, k) for a in t_cont.ANGULAR for e in ("tabular", "nbody") for k in (0, 4)])
def test_cm_kernel_every_lane_group_matches_plain_version_on_the_card(variant, lanes):
    """Every template instance at P3 (its L bucket 3) under each lane group G, forced."""
    _need_card()
    args, chunk = _cm_operands(*variant)
    args = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
    t_cont.cm_inner_moments.lane_groups.clear()
    got = t_cont.cm_inner_moments(*args, lanes=lanes)
    torch.cuda.synchronize()
    assert dict(t_cont.cm_inner_moments.lane_groups) == {lanes: 1}
    _row_close(got.cpu(), t_cont.cm_inner_moments_ref(*args, chunk=chunk).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 8])
def test_two_launches_of_one_tile_are_bit_equal_on_the_card(lanes):
    """The lane groups' sums meet in a fixed butterfly: the same tile twice
    gives the same bits, for both kernels."""
    _need_card()
    pm, ph, v, awr, kt = (x.cuda() for x in _sab_operands(awr=0.999167, rows=16, order=5))
    a = t_fg.sab_density(pm, ph, v, awr, kt, 5, lanes=lanes)
    b = t_fg.sab_density(pm, ph, v, awr, kt, 5, lanes=lanes)
    args, _ = _cm_operands("tabular", "tabular", 4)
    args = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
    c = t_cont.cm_inner_moments(*args, lanes=lanes)
    d = t_cont.cm_inner_moments(*args, lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1, 3, 5, 10])
@pytest.mark.parametrize("variant", [("kalbach", "tabular", 4), ("tabular", "tabular", 0)])
def test_cm_kernel_orders_cross_every_bucket_on_the_card(variant, order):
    """Orders 0, 1 and 3 (bucket 3), 5 (bucket 5) and 10 (bucket 10)."""
    _need_card()
    d = _cm_inputs(seed=5, t=4)
    seen = {}
    real = t_cont.cm_inner_moments

    def capture(*args, chunk=None, lanes=None):
        seen["call"] = (args, chunk)
        return real(*args, chunk=chunk, lanes=lanes)

    angular, energy, ksel = variant
    nb, kal, tab = energy == "nbody", angular == "kalbach", angular == "tabular"
    t_cont.cm_inner_moments = capture
    try:
        t_cont.cm_moments_pointwise(
            _t(d["e"]), _t(d["kn"]), _t(d["pd"]), _t(d["rr"]) if kal else None, _t(d["aa"]) if kal else None,
            _t(d["muk"]) if tab else None, _t(d["mup"]) if tab else None, None, 0.5, _t(_bounds(12)), AWR, order,
            4, 4, angular, energy, True, 8, ksel, "lagrange", tab,
        )
    finally:
        t_cont.cm_inner_moments = real
    args, chunk = seen["call"]
    args = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
    got = t_cont.cm_inner_moments(*args)
    torch.cuda.synchronize()
    assert got.shape[-1] == order + 1 and not nb
    _row_close(got.cpu(), t_cont.cm_inner_moments_ref(*args, chunk=chunk).cpu(), atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["kalbach", "nbody"])
def test_cm_kernel_matches_plain_version_on_the_deployment_rows(which, tmp_path):
    """The fast deployment's rows of tests/test_torch_continuum_deployment.py
    (U-238's Kalbach (n,2n) at its top 8 incident rows, 47 groups, P3;
    H-2's N-body (n,2n) near E'_lab = 0, 361 groups, P5) through the
    continuum driver on the card and on the CPU: the kernel against its
    plain version within 1e-12 of each row's scale."""
    _need_card()
    import test_torch_continuum_deployment as dep

    case = dep.KALBACH_CASES[0] if which == "kalbach" else dep.NBODY_CASE
    before = t_cont.cm_inner_moments.launches
    got = dep.port_rows(case, tmp_path / "cuda", "cuda")[2]
    assert t_cont.cm_inner_moments.launches > before
    _row_close(got, dep.port_rows(case, tmp_path / "cpu", "cpu")[2], atol=0.0)
