"""The port stands alone: it imports no jax, and its kernel wrapper keeps the
CPU (plain torch) and CUDA (hand-written kernel) routes apart and refuses what
the kernel does not take."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from ndpp_tpu_torch.ops import twobody_inner as inner_mod
from ndpp_tpu_torch.ops.segment import segment_group_sum
from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments, twobody_group_moments_ref, twobody_inner_ref

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

MODULES = [
    "ndpp_tpu_torch",
    "ndpp_tpu_torch.banding",
    "ndpp_tpu_torch.chi_driver",
    "ndpp_tpu_torch.cli",
    "ndpp_tpu_torch.config",
    "ndpp_tpu_torch.continuum_driver",
    "ndpp_tpu_torch.driver",
    "ndpp_tpu_torch.freegas_driver",
    "ndpp_tpu_torch.groups",
    "ndpp_tpu_torch.host.ace.parse",
    "ndpp_tpu_torch.host.ace.synth",
    "ndpp_tpu_torch.host.ace.thermal",
    "ndpp_tpu_torch.host.ace.write",
    "ndpp_tpu_torch.host.library_index",
    "ndpp_tpu_torch.host.angular_moments",
    "ndpp_tpu_torch.host.prep",
    "ndpp_tpu_torch.host.prep_continuum",
    "ndpp_tpu_torch.host.prep_thermal",
    "ndpp_tpu_torch.host.unionize",
    "ndpp_tpu_torch.interop",
    "ndpp_tpu_torch.native",
    "ndpp_tpu_torch.io.library",
    "ndpp_tpu_torch.ops.chi",
    "ndpp_tpu_torch.ops.continuum",
    "ndpp_tpu_torch.ops.freegas",
    "ndpp_tpu_torch.ops.legendre",
    "ndpp_tpu_torch.ops.panelsplit",
    "ndpp_tpu_torch.ops.segment",
    "ndpp_tpu_torch.ops.thermal",
    "ndpp_tpu_torch.ops.twobody",
    "ndpp_tpu_torch.ops.twobody_inner",
    "ndpp_tpu_torch.parallel.mesh",
    "ndpp_tpu_torch.parallel.nuclides",
    "ndpp_tpu_torch.parallel.rows",
    "ndpp_tpu_torch.selfcheck",
    "ndpp_tpu_torch.thermal_driver",
    "ndpp_tpu_torch.utils.build",
    "ndpp_tpu_torch.utils.watchdog",
]


def test_port_imports_without_jax_or_h5py():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'ndpp_tpu' or k.startswith('ndpp_tpu.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _inputs(t=6, s=9, seed=3, groups=5, per_row=False, band=4):
    """Panels as the prologue makes them (mid sorted per row, so E'_lab(mid)
    is non-decreasing), dead subintervals (half == 0), some rows below
    threshold, and group bounds that leave part of the reach outside the
    table, with some boundaries exactly ON a midpoint's E'_lab. Returns
    (mid, half, a_s, b_s, kin, valid_e, bounds) as CPU tensors."""
    rng = np.random.default_rng(seed)
    mid = np.sort(rng.uniform(-1, 1, size=(t, s)), axis=1)
    half = rng.uniform(0.0, 2.0 / max(s, 1), size=(t, s))
    half[rng.random((t, s)) < 0.1] = 0.0
    half[::2, s // 4 : s // 4 + 70] = 0.0  # whole chunks of dead subintervals, as clamped breakpoints leave
    a_s = rng.uniform(0.2, 0.8, size=(t, s))
    b_s = rng.uniform(-0.2, 0.2, size=(t, s))
    e = rng.uniform(1.0, 1e3, size=t)
    awr = rng.uniform(1.0, 60.0, size=t)
    ecm = e * (awr / (awr + 1.0)) ** 2
    kin = np.stack([ecm + e / (awr + 1.0) ** 2, 2.0 * np.sqrt(e * ecm) / (awr + 1.0), np.sqrt(ecm), np.sqrt(e) / (awr + 1.0)], axis=1)
    valid_e = rng.random(t) > 0.15
    elab = kin[:, 0:1] + kin[:, 1:2] * mid  # rounded as torch rounds it: a product, then a sum
    table = np.geomspace(np.quantile(elab, 0.05), np.quantile(elab, 0.95), groups + 1)
    hits = rng.choice(elab.ravel(), size=min(5, groups - 1, elab.size), replace=False)
    table[1 : 1 + hits.size] = hits
    table.sort()
    bounds = table
    if per_row:
        g0 = np.clip(np.searchsorted(table, elab[:, 0]) - 2, 0, groups - band)
        bounds = table[g0[:, None] + np.arange(band + 1)[None, :]]
    return [torch.as_tensor(x) for x in (mid, half, a_s, b_s, kin, valid_e, bounds)]


def _plain_cpu_path(mid, half, a_s, b_s, kin, valid_e, bounds, order, nq, clamp):
    """The CPU path before the kernel was fused: inner stage, mask, segment sum."""
    m = twobody_inner_ref(mid, half, a_s, b_s, kin, order, nq)
    m = m * ((half > 0.0) & valid_e[:, None])[:, None, :]
    elab_mid = kin[:, 0:1] + kin[:, 1:2] * mid
    return segment_group_sum(m, elab_mid, bounds, clamp)


def test_cpu_tensors_take_the_plain_version_and_never_count():
    before = twobody_group_moments.launches
    args = _inputs()
    out = twobody_group_moments(*args, 4, 8, True)
    assert twobody_group_moments.launches == before == 0
    assert out.shape == (6, 5, 5) and out.dtype == torch.float64
    torch.testing.assert_close(out, twobody_group_moments_ref(*args, 4, 8, True), rtol=0, atol=0)
    torch.testing.assert_close(out, _plain_cpu_path(*args, 4, 8, True), rtol=0, atol=0)
    # P0 of a linear pdf over a symmetric rule is exact: half * sum_q w_q (a + b mu_q),
    # and with clamp every live subinterval lands in some group
    mid, half, a_s, b_s, _, valid_e, _ = args
    live = (half > 0) & valid_e[:, None]
    torch.testing.assert_close(
        out[:, 0, :].sum(dim=1), (2.0 * half * (a_s + b_s * mid) * live).sum(dim=1), rtol=1e-13, atol=1e-16
    )
    assert not out[~valid_e].any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _inputs()
    with pytest.raises(TypeError, match="float64"):
        twobody_group_moments(*[x.float() if x.is_floating_point() else x for x in args], 3, 8, True)
    with pytest.raises(ValueError, match="order"):
        twobody_group_moments(*args, 11, 8, True)
    with pytest.raises(ValueError, match="kin"):
        twobody_group_moments(*args[:4], args[4][:, :3].contiguous(), *args[5:], 3, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        twobody_group_moments(args[0].t().contiguous().t(), *args[1:], 3, 8, True)


@pytest.mark.parametrize("clamp", [True, False])
def test_group_moments_shared_and_per_row_bounds(clamp):
    """Per-row windows are each row's own table: the (T, B+1) call equals
    row-by-row calls with that row's (B+1,) bounds, and windows that are the
    whole table equal the shared-table call."""
    *panels, valid_e, bounds = _inputs(t=5, s=40, seed=8, groups=12, per_row=True, band=4)
    out = twobody_group_moments(*panels, valid_e, bounds, 3, 8, clamp)
    assert out.shape == (5, 4, 4)
    for t in range(5):
        row = [x[t : t + 1] for x in panels]
        torch.testing.assert_close(
            out[t : t + 1], twobody_group_moments(*row, valid_e[t : t + 1], bounds[t], 3, 8, clamp), rtol=0, atol=0
        )
    *panels, valid_e, table = _inputs(t=5, s=40, seed=8, groups=12)
    whole = table.expand(5, table.shape[0]).contiguous()
    torch.testing.assert_close(
        twobody_group_moments(*panels, valid_e, whole, 3, 8, clamp),
        twobody_group_moments(*panels, valid_e, table, 3, 8, clamp),
        rtol=0, atol=0,
    )


def test_group_moments_valid_e_dtype():
    *panels, valid_e, bounds = _inputs(seed=4)
    assert not valid_e.all()
    out = twobody_group_moments(*panels, valid_e, bounds, 2, 8, True)
    torch.testing.assert_close(twobody_group_moments(*panels, valid_e.to(torch.uint8), bounds, 2, 8, True), out, rtol=0, atol=0)
    with pytest.raises(TypeError, match="valid_e"):
        twobody_group_moments(*panels, valid_e.double(), bounds, 2, 8, True)
    with pytest.raises(ValueError, match="valid_e"):
        twobody_group_moments(*panels, valid_e[:-1], bounds, 2, 8, True)


def test_group_moments_rejects_orders_and_rules_the_kernel_lacks():
    args = _inputs()
    for order in (-1, 11, 12):
        with pytest.raises(ValueError, match="order"):
            twobody_group_moments(*args, order, 8, True)
    for nq in (0, 65):
        with pytest.raises(ValueError, match="nq"):
            twobody_group_moments(*args, 3, nq, True)
    twobody_group_moments(*args, 10, 64, True)  # the largest order and rule it takes


def test_group_moments_rejects_float32_and_non_contiguous_inputs():
    args = _inputs(per_row=True)
    for i in (0, 1, 2, 3, 4, 6):
        bad = list(args)
        bad[i] = bad[i].float()
        with pytest.raises(TypeError, match="float64"):
            twobody_group_moments(*bad, 3, 8, True)
        bad[i] = args[i].t().contiguous().t() if args[i].dim() == 2 else args[i].repeat_interleave(2)[::2]
        assert not bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="contiguous"):
            twobody_group_moments(*bad, 3, 8, True)
    with pytest.raises(ValueError, match="bounds"):
        twobody_group_moments(*args[:6], args[6][:-1], 3, 8, True)  # per-row bounds for fewer rows


def test_kernel_source_and_build_flags():
    """The CUDA route builds only from the repository's own source, for sm_90a,
    into the ignored build directory, with ptxas's register report."""
    assert inner_mod._SRC.name == "twobody_inner.cu" and inner_mod._SRC.exists()
    assert "arch=compute_90a,code=sm_90a" in inner_mod._NVCC_FLAGS
    assert inner_mod._NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    assert inner_mod._BUILD_DIR.parts[-2:] == ("build", "ndpp_tpu_torch")
    src = inner_mod._SRC.read_text()
    assert 'extern "C" int twobody_group_launch' in src and "twobody_inner_launch" not in src


# (rows, S, G, per-row band B or 0, clamp, order, nq): S = 300 is not a
# multiple of 32 and spans ten chunks; G = 4 makes runs longer than a chunk;
# G = 361 with S = 40 leaves most groups empty.
CARD_CASES = [
    (64, 300, 4, 0, True, 5, 16),
    (64, 300, 4, 0, False, 0, 12),
    (64, 40, 361, 0, True, 10, 16),
    (64, 40, 361, 0, False, 5, 12),
    (64, 300, 361, 32, True, 5, 16),
    (64, 300, 361, 32, False, 10, 12),
    (64, 33, 24, 0, True, 0, 16),
]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run python3 chip_smoke.py on the card)")
    twobody_group_moments.launches = 0
    for i, (t, s, g, band, clamp, order, nq) in enumerate(CARD_CASES):
        args = [x.cuda() for x in _inputs(t=t, s=s, seed=i, groups=g, per_row=band > 0, band=band)]
        out = twobody_group_moments(*args, order, nq, clamp)
        torch.cuda.synchronize()
        ref = twobody_group_moments_ref(*args, order, nq, clamp)
        assert out.shape == ref.shape == (t, order + 1, band or g)
        torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-14, msg=lambda m, c=CARD_CASES[i]: f"{c}: {m}")
    assert twobody_group_moments.launches == len(CARD_CASES)
    # the driver's result copies rely on a non-blocking copy off the card landing in pinned memory
    assert out.to("cpu", non_blocking=True).is_pinned()


@pytest.mark.cuda
def test_continuum_and_chi_stay_on_the_card(monkeypatch):
    """On device="cuda" every op result of the continuum and chi drivers is a
    float64 tensor on the card until its one copy back, which lands in pinned
    host memory; the values agree with the CPU run of the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py on the card)")
    import types

    from ndpp_tpu_torch import chi_driver, continuum_driver, groups
    from ndpp_tpu_torch.config import RunConfig
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.parallel import rows as rows_mod

    seen = []
    fetch = rows_mod.Placement.fetch

    def spy(place, res):
        host = fetch(place, res)
        seen.append((res.device.type, res.dtype, host.is_pinned() or res.device.type == "cpu"))
        return host

    monkeypatch.setattr(rows_mod.Placement, "fetch", spy)
    gs = groups.get("uniform-lethargy-47")
    cfg = RunConfig(freegas_for=["none"])
    out = {}
    for dev in ("cuda", "cpu"):
        seen.clear()
        device = torch.device(dev)
        for key, mt in (("kalbach", 91), ("law61cm", 22), ("law4nd", 91), ("nbody", 16)):
            nuc = synth.build(key)
            out[dev, key] = continuum_driver.continuum_reaction_moments(
                nuc, nuc.reactions[mt], nuc.energy[-6:], gs, 3, cfg, device)
        for key in ("u235", "watt"):
            nuc = synth.build(key)
            res = types.SimpleNamespace(energy=nuc.energy[-6:])
            chi_driver.chi_collapse(res, nuc, gs, cfg, device)
            out[dev, key] = res.chi_total
        assert len(seen) >= 6
        assert all(s == (dev, torch.float64, True) for s in seen), seen
    for (dev, key), got in out.items():
        if dev == "cuda":
            ref = out["cpu", key]
            assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max(), key


@pytest.mark.cuda
def test_thermal_drivers_stay_on_the_card(monkeypatch):
    """On device="cuda" apply_sab and apply_freegas keep every op result on
    the card as float64 until its one copy back into pinned host memory, and
    give the values of the CPU run: S(alpha,beta) on h1 (lwtr) and o16
    (grph), then free-gas above each table's range; free-gas alone on fe56,
    at two temperatures."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py on the card)")
    from ndpp_tpu_torch import driver, freegas_driver, thermal_driver
    from ndpp_tpu_torch.config import RunConfig
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.parallel import rows as rows_mod

    seen = []
    fetch = rows_mod.Placement.fetch

    def spy(place, res):
        host = fetch(place, res)
        seen.append((res.device.type, res.dtype, host.is_pinned() or res.device.type == "cpu"))
        return host

    monkeypatch.setattr(rows_mod.Placement, "fetch", spy)
    cfg = RunConfig(groups="uniform-lethargy-47", legendre_order=3, temperatures=[293.6, 600.0])
    cfg.validate()
    gs = cfg.group_structure()
    out = {}
    for dev in ("cuda", "cpu"):
        seen.clear()
        device = torch.device(dev)
        for key, table in (("h1", "lwtr"), ("o16", "grph"), ("fe56", None)):
            nuc = synth.ALL_FIXTURES[key](40)
            e_grid = unionize.moment_grid(nuc.energy)
            base, _, elastic0k = driver.scattering_moments(nuc, gs, cfg, e_grid, device)
            scatter = np.broadcast_to(base, (2,) + base.shape).copy()
            e_min = None
            if table:
                tabs = thermal_driver.match_tables([synth.build_thermal(table)], cfg.temperatures)
                scatter = thermal_driver.apply_sab(scatter, nuc, gs, cfg, e_grid, tabs, device)
                e_min = thermal_driver.sab_e_max(tabs)
            out[dev, key] = freegas_driver.apply_freegas(scatter, nuc, gs, cfg, e_grid, device, None, e_min, elastic0k)
        assert len(seen) >= 9
        assert all(s == (dev, torch.float64, True) for s in seen), seen
    for key in ("h1", "o16", "fe56"):
        ref = out["cpu", key]
        assert np.abs(out["cuda", key] - ref).max() <= 1e-13 * np.abs(ref).max(), key


@pytest.mark.cuda
def test_selfcheck_at_production_shape_on_the_card():
    """ndpp_tpu_torch.selfcheck at its defaults (2048 rows, P5, 361 groups,
    nq 16): the two-body kernel against its plain version on the card, and
    every family under the reference's gates."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run python3 chip_smoke.py on the card)")
    from ndpp_tpu_torch import selfcheck

    report = selfcheck.run(device="cuda")
    print(report)
    assert report["twobody_route"] == "cuda" and report["twobody_kernel_launches"] >= 1
    assert report["twobody_max_rel"] <= 1e-8
    assert report["ok"], report["failed"]


@pytest.mark.cuda
def test_two_shards_on_one_card_each_launch_on_their_stream(tmp_path):
    """driver.run over two shards on one card (cuda:0 twice: two streams)
    writes the library of its one-shard run within 1e-13 relative, 1e-16
    absolute, every family on, and the kernel launches on both streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run python3 chip_smoke.py on the card)")
    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.config import RunConfig
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.ace.thermal import write_thermal_ace
    from ndpp_tpu_torch.host.ace.write import write_ace
    from ndpp_tpu_torch.io.library import compare
    from ndpp_tpu_torch.parallel.rows import Placement

    lines = []
    for key in ("h1", "o16", "kalbach", "u235"):
        nuc = synth.ALL_FIXTURES[key](60)
        lines.append(f"{nuc.name} {nuc.awr:.6f} {write_ace(nuc, tmp_path / f'{key}.ace').name} 0 1 1 0")
    tab = synth.build_thermal("lwtr")
    lines.append(f"{tab.name} {tab.awr:.6f} {write_thermal_ace(tab, tmp_path / 'lwtr.ace').name} 0 1 1 0")
    (tmp_path / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
    place = Placement(["cuda:0", "cuda:0"])
    paths = {}
    for tag, device in (("one", "cuda:0"), ("two", place)):
        cfg = RunConfig(library=str(tmp_path / "xsdir"), groups="uniform-lethargy-47", legendre_order=3,
                        sab={"1001.80c": ["lwtr.20t"]})
        cfg.output.path = str(tmp_path / f"{tag}.txt")
        cfg.output.format = "ascii"
        cfg.device.e_tile = 64
        cfg.validate()
        twobody_group_moments.launches_by_stream.clear()
        m = driver.run(cfg, device=device)
        assert m.nuclides_done == 4 and m.nuclides_quarantined == 0
        paths[tag] = cfg.output.path
    by_stream = dict(twobody_group_moments.launches_by_stream)
    assert all(by_stream.get(s.cuda_stream, 0) > 0 for s in place.streams), by_stream
    report = compare(paths["two"], paths["one"], rtol=1e-13, atol=1e-16)
    assert report["match"], {k: v for k, v in report["datasets"].items() if not v.get("ok")}
