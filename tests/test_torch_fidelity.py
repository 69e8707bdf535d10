"""The port's analog-fidelity path against the JAX package, on the CPU.

Seeded numpy inputs go into both packages (the JAX package on its
``ref`` / ``interpret`` backends, as its own tests run it).  Bands, each
measured on this suite's inputs and stated in ``PERF.md``:

  * threefry bits and uniform floats: bitwise (``core.prng`` reproduces
    jax 0.9's partitionable stream);
  * normals: <= 4 ULP (measured 3).  ``erf_inv`` is XLA's polynomial
    written out in torch; XLA contracts its multiply-adds into FMAs and
    has its own ``log1p``, so ~5 % of normals differ by 1-3 ULP;
  * ``cell_eps`` and ``sample_variability``'s planes: <= 2 ULP;
  * ``ts_analog_read`` on equal inputs: <= 4 ULP from the JAX op (the
    reference's own interpret-vs-oracle bar; measured 3: two ``exp`` and
    one ``pow``), and bitwise from the port's own ``ts_analog_read_ref``;
  * engine reads with noise drawn on each side: analog_3d <= 4 ULP,
    analog_2d <= 8 ULP (``pow`` of ``1 - alpha`` to row hit counts in the
    hundreds; measured 3 and 5); comparator products (masks, analog STCF
    counts, denoise labels) may differ only at cells whose reference
    voltage lies within that band of ``V_tw``;
  * sigma = 0: bitwise the digital read, inside the port;
  * the energy model (host floats): ``==``.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edram as jedram
from repro.core import isc_array as jisc
from repro.core import time_surface as jts
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.hw import energy_model as jem
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import fidelity as jfm
from repro.serve import spec as jrs
from repro.serve import ts_engine as jeng
from repro_torch import convert
from repro_torch.core import edram as tedram
from repro_torch.core import isc_array as tisc
from repro_torch.core import prng
from repro_torch.core import time_surface as tts
from repro_torch.events import replay as rp
from repro_torch.hw import energy_model as tem
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve import fidelity as fm
from repro_torch.serve import spec as rs
from repro_torch.serve.stream import StreamConfig
from repro_torch.serve.ts_engine import TSEngineConfig, TimeSurfaceEngine

jax.config.update("jax_platforms", "cpu")

NORMAL_ULP = 4
EPS_ULP = 2
ANALOG_ULP = 4
ANALOG_2D_ULP = 8

H, W, CHUNK = 32, 48, 64


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ulp(a, b) -> int:
    return int(tref.ulp_distance(torch.as_tensor(a), _t(b)).max())


def _cfg(**kw):
    base = dict(h=H, w=W, n_slots=4, chunk_capacity=CHUNK, mode="edram")
    base.update(kw)
    return TSEngineConfig(**base)


def _engine(**kw):
    return TimeSurfaceEngine(_cfg(**kw), device="cpu")


def _burst(rng, n=CHUNK, t_lo=0.0, t_hi=0.05):
    return tts.EventBatch(
        x=torch.from_numpy(rng.integers(0, W, n).astype(np.int32)),
        y=torch.from_numpy(rng.integers(0, H, n).astype(np.int32)),
        p=torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
        t=torch.from_numpy(np.sort(rng.uniform(t_lo, t_hi, n))
                           .astype(np.float32)),
        valid=torch.ones(n, dtype=torch.bool),
    )


# ---------------------------------------------------------------------------
# the noise stream
# ---------------------------------------------------------------------------

PRNG_CASES = [(0, 0, 1, (2, 24, 32)), (7, 3, 5, (1000,)),
              (2 ** 31 - 1, 99, 0, (2, 40, 72)),
              (5, -1, 2 ** 31 - 1, (4, 33))]


@pytest.mark.parametrize("seed, step, gen, shape", PRNG_CASES)
def test_prng_matches_jax(seed, step, gen, shape):
    """Keys, bits and uniforms bitwise jax's; normals within NORMAL_ULP."""
    jk = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(step)),
        jnp.int32(gen))
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), step), gen)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform(tk, shape).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, shape, jnp.float32)).view(np.int32))
    assert _ulp(prng.normal(tk, shape),
                jax.random.normal(jk, shape, jnp.float32)) <= NORMAL_ULP


def test_prng_batched_keys_match_single_draws():
    """fold_in over a tensor of data batches: key s draws what its own
    single key draws, bitwise."""
    base = prng.fold_in(prng.PRNGKey(3), 4)
    gens = torch.tensor([1, 2, 9], dtype=torch.int32)
    batched = prng.normal(prng.fold_in(base, gens), (2, 8, 8))
    for i, g in enumerate(gens.tolist()):
        one = prng.normal(prng.fold_in(base, g), (2, 8, 8))
        assert torch.equal(batched[i], one)


def test_erf_inv_matches_xla():
    """The written-out polynomial against XLA's ErfInv on 10^5 seeded
    points of (-1, 1) and the edges."""
    from jax._src.lax import special

    x = np.random.default_rng(0).uniform(-1, 1, 100_000).astype(np.float32)
    x = np.concatenate([x, np.float32([-1.0, 1.0, 0.0, -0.99999994])])
    got = prng.erf_inv(_t(x))
    want = np.asarray(jax.jit(special.erf_inv)(x))
    assert torch.equal(torch.isinf(got), _t(np.isinf(want)))
    fin = np.isfinite(want)
    assert _ulp(got[_t(fin)], want[fin]) <= 2


@pytest.mark.parametrize("sigma", [None, 0.2])
@pytest.mark.parametrize("step", [0, 5, 123])
def test_cell_eps_matches_reference(sigma, step):
    gen = np.array([1, 3, 7, 2], np.int32)
    want = jfm.cell_eps(jfm.analog_3d(sigma=sigma, seed=4), step,
                        jnp.asarray(gen), (2, 24, 32))
    got = fm.cell_eps(fm.analog_3d(sigma=sigma, seed=4), step,
                      torch.from_numpy(gen), (2, 24, 32))
    assert got.shape == (4, 2, 24, 32) and got.dtype == torch.float32
    assert _ulp(got, want) <= EPS_ULP


@pytest.mark.parametrize("sigma", [None, 0.1])
def test_sample_variability_matches_reference(sigma):
    shape = (2, 24, 32)
    want = jedram.sample_variability(jax.random.PRNGKey(5), shape,
                                     jedram.decay_params_for_cmem(), sigma)
    got = tedram.sample_variability(prng.PRNGKey(5), shape,
                                    tedram.decay_params_for_cmem(), sigma)
    for a, b in zip(got, want):
        assert a.shape == shape
        assert _ulp(a, b) <= EPS_ULP


# ---------------------------------------------------------------------------
# the analog read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_ts_analog_read_matches_reference(seed):
    """Seeded geometry as ``check_ts_analog_read``: spread + half-select
    and spread alone within ANALOG_ULP of the JAX oracle (which the JAX
    op's ``ref`` backend equals bitwise, and its ``interpret`` backend
    within 4 ULP, as the JAX package's own tests hold it; seed 0 checks
    the op itself); the port's op bitwise its own per-cell plain
    version; no spread and no hits bitwise ``ts_decay``."""
    rng = np.random.default_rng(seed)
    h, w, p = int(rng.integers(8, 48)), int(rng.integers(8, 150)), \
        int(rng.integers(1, 3))
    t_now = float(rng.uniform(0.02, 0.1))
    sae = np.where(rng.random((p, h, w)) < 0.3, -np.inf,
                   rng.uniform(0.0, t_now, (p, h, w))).astype(np.float32)
    eps = (1.0 + 0.05 * rng.standard_normal((p, h, w))).astype(np.float32)
    row = rng.integers(0, 200, (1, h)).astype(np.int32)
    col = rng.integers(0, 200, (1, w)).astype(np.int32)
    alpha, coupling = float(rng.uniform(0, 0.1)), float(rng.uniform(0, 0.01))
    jp, tp = jedram.decay_params_for_cmem(), tedram.decay_params_for_cmem()
    hs = dict(alpha=alpha, coupling=coupling)
    got = tops.ts_analog_read(_t(sae), t_now, tp, eps=_t(eps),
                              row_hits=_t(row), col_hits=_t(col), **hs)
    assert torch.equal(got, tref.ts_analog_read_ref(
        _t(sae), t_now, tp, eps=_t(eps), row_hits=_t(row),
        col_hits=_t(col), **hs))
    jargs = (jnp.asarray(sae), t_now, jp)
    jkw = dict(eps=jnp.asarray(eps), row_hits=jnp.asarray(row),
               col_hits=jnp.asarray(col), **hs)
    assert _ulp(got, jref.ts_analog_read_ref(*jargs, **jkw)) <= ANALOG_ULP
    if seed == 0:
        assert _ulp(got, jops.ts_analog_read(
            *jargs, **jkw, backend="interpret")) <= ANALOG_ULP
    spread = tops.ts_analog_read(_t(sae), t_now, tp, eps=_t(eps))
    assert torch.equal(spread, tref.ts_analog_read_ref(_t(sae), t_now, tp,
                                                       eps=_t(eps)))
    assert _ulp(spread, jref.ts_analog_read_ref(
        *jargs, eps=jnp.asarray(eps))) <= ANALOG_ULP
    anchor = tops.ts_analog_read(_t(sae), t_now, tp)
    assert torch.equal(anchor, tops.ts_decay(_t(sae), t_now, tp))
    with pytest.raises(ValueError, match="together"):
        tops.ts_analog_read(_t(sae), t_now, tp, row_hits=_t(row))


def test_apply_half_select_matches_reference():
    rng = np.random.default_rng(3)
    v = rng.uniform(0, 0.6, (24, 32)).astype(np.float32)
    rows = rng.integers(0, 50, 24).astype(np.int32)
    cols = rng.integers(0, 50, 32).astype(np.int32)
    want = jedram.apply_half_select(jnp.asarray(v), jnp.asarray(rows),
                                    jnp.asarray(cols))
    got = tedram.apply_half_select(_t(v), _t(rows), _t(cols))
    assert _ulp(got, want) <= ANALOG_ULP
    assert (tedram.HALF_SELECT_ALPHA, tedram.HALF_SELECT_COUPLING) == (
        jedram.HALF_SELECT_ALPHA, jedram.HALF_SELECT_COUPLING)


# ---------------------------------------------------------------------------
# the model object and spec resolution (the reference's cases)
# ---------------------------------------------------------------------------

def test_fidelity_model_frozen_hashable_validated():
    a = fm.analog_3d()
    assert a == fm.analog_3d() and hash(a) == hash(fm.analog_3d())
    assert a.is_analog and not fm.IDEAL.is_analog
    assert fm.analog_2d().mode == "analog_2d"
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.sigma = 0.5
    for bad in (lambda: fm.FidelityModel(mode="analog_4d"),
                lambda: fm.analog_3d(sigma=-0.1),
                lambda: fm.analog_2d(alpha=1.0),
                lambda: fm.analog_2d(coupling=-0.01)):
        with pytest.raises(ValueError):
            bad()
    assert fm.resolved_sigma(a) == jfm.resolved_sigma(jfm.analog_3d())


def test_spec_fidelity_resolution():
    sp = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d()))
    assert fm.spec_fidelity_mode(sp) == "analog_3d"
    assert fm.spec_needs_noise(sp) and not fm.spec_needs_hits(sp)
    sp2 = rs.ReadoutSpec(
        surface=rs.surface(),
        stcf=rs.stcf(decay=rs.surface(fidelity=fm.analog_2d())))
    assert fm.spec_fidelity_mode(sp2) == "analog_2d"
    assert fm.spec_needs_hits(sp2) and rs.needs_counts(sp2)
    assert fm.spec_fidelity_mode(rs.SURFACE_SPEC) == "ideal"
    sp0 = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d(sigma=0.0)))
    assert not fm.spec_needs_noise(sp0)


def test_analog_requires_edram_mode():
    spec = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d()))
    eng = _engine(mode="ideal", specs=(spec,))
    with pytest.raises(ValueError, match="ideal"):
        eng.read(spec, 0.06)


def test_analog_2d_requires_counter_plane():
    spec2 = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_2d()))
    eng = _engine()                     # no counts-bearing spec declared
    with pytest.raises(ValueError, match="counter plane|analog_2d"):
        eng.read(spec2, 0.06)


def test_noise_read_without_step_raises():
    """A noise-drawing product read without the key inputs raises (the
    engine always passes them; a bare spec read may not)."""
    spec = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d()))
    eng = _engine(specs=(spec,))
    with pytest.raises(ValueError, match="noise_step"):
        rs.read_compiled(eng.state.surfaces.sae, eng.state.counts, 0.06,
                         rs.compile_spec(spec, eng.cfg), eng.cfg)


# ---------------------------------------------------------------------------
# engine reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fid", [fm.analog_3d(sigma=0.0),
                                 fm.analog_3d(sigma=0.0, seed=9)])
def test_sigma_zero_anchor_bitwise(fid):
    """sigma = 0, no disturbance: the analog read is bitwise the digital
    read, for the surface, the mask and the STCF support."""
    a = rs.surface(fidelity=fid)
    anchor = rs.ReadoutSpec(surface=a, mask=rs.mask(decay=a),
                            stcf=rs.stcf(decay=a))
    digital = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                             stcf=rs.stcf())
    eng = _engine(specs=(anchor, digital))
    cam = eng.attach()
    eng.push([(cam, _burst(np.random.default_rng(0)))])
    got, want = eng.read(anchor, 0.06, 5), eng.read(digital, 0.06)
    assert torch.equal(got["surface"].view(torch.int32),
                       want["surface"].view(torch.int32))
    assert torch.equal(got["mask"], want["mask"])
    assert torch.equal(got["stcf"], want["stcf"])


def test_noise_deterministic_per_step_and_generation():
    spec = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d()))
    eng = _engine(specs=(spec,))
    cam = eng.attach()
    eng.push([(cam, _burst(np.random.default_rng(1)))])
    r0 = eng.read(spec, 0.06, noise_step=0)["surface"]
    r0b = eng.read(spec, 0.06, noise_step=0)["surface"]
    r1 = eng.read(spec, 0.06, noise_step=1)["surface"]
    assert torch.equal(r0.view(torch.int32), r0b.view(torch.int32))
    assert not torch.equal(r0, r1)
    gen0 = cam.generation
    cam.detach()
    cam2 = eng.attach()
    assert cam2.generation != gen0
    eng.push([(cam2, _burst(np.random.default_rng(1)))])
    assert not torch.equal(eng.read(spec, 0.06, noise_step=0)["surface"], r0)


def test_one_draw_per_read_shared_by_products():
    """Within one read every product with the same (seed, sigma) reuses
    one draw: the analog mask is exactly the analog surface > V_tw."""
    a = rs.surface(fidelity=fm.analog_3d())
    spec = rs.ReadoutSpec(surface=a, mask=rs.mask(decay=a))
    eng = _engine(specs=(spec,))
    cam = eng.attach()
    eng.push([(cam, _burst(np.random.default_rng(2)))])
    out = eng.read(spec, 0.06, noise_step=4)
    assert torch.equal(out["mask"], out["surface"] > eng.cfg.v_tw())


def test_analog_2d_shows_half_select_droop():
    spec3 = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d(sigma=0.0)))
    spec2 = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_2d(sigma=0.0)))
    eng = _engine(specs=(spec3, spec2))
    cam = eng.attach()
    eng.push([(cam, _burst(np.random.default_rng(2)))])
    v3 = eng.read(spec3, 0.06)["surface"][cam.slot]
    v2 = eng.read(spec2, 0.06)["surface"][cam.slot]
    assert v2.sum() < v3.sum()          # disturbance only ever droops
    assert bool((v2 <= v3 + 1e-7).all())


def test_analog_spec_bypasses_the_tile_cache():
    """serve_step of an analog spec is the dense ``read`` of it, noise
    step included, and leaves the digital cache epoch alone."""
    spec = rs.ReadoutSpec(surface=rs.surface(fidelity=fm.analog_3d()))
    eng = _engine(specs=(spec,))
    cam = eng.attach()
    got = eng.serve_step([(cam, _burst(np.random.default_rng(6)))], spec,
                         0.06, noise_step=2)
    assert torch.equal(got["surface"], eng.read(spec, 0.06, 2)["surface"])
    assert eng._cache_t is None


def _pair(spec_of, **kw):
    """A JAX (``ref``) and a port engine, equal configs, three sensors fed
    the same packed scene words."""
    jspec, tspec = spec_of(jrs, jfm), spec_of(rs, fm)
    base = dict(h=40, w=72, polarities=2, n_slots=3, chunk_capacity=512, **kw)
    je = jeng.TimeSurfaceEngine(jeng.TSEngineConfig(**base, backend="ref",
                                                    specs=(jspec,)))
    te = TimeSurfaceEngine(TSEngineConfig(**base, specs=(tspec,)),
                           device="cpu")
    words = [jaer.pack(jdatasets.dnd21_like(("driving", "hotel_bar")[i % 2],
                                            40, 72, 0.04, seed=i))
             for i in range(3)]
    for eng in (je, te):
        for _ in words:
            eng.attach()
        eng.push(list(enumerate(words)))
    return je, te, jspec, tspec


def _full_spec(m, f):
    a3, a2 = m.surface(fidelity=f.analog_3d()), m.surface(
        fidelity=f.analog_2d())
    return m.ReadoutSpec(surface=a3, mask=m.mask(decay=a3),
                         stcf=m.stcf(decay=a3), labels=m.denoise(),
                         s2=a2, m2=m.mask(decay=a2), st2=m.stcf(decay=a2))


@pytest.mark.parametrize("step", [0, 3])
def test_engine_analog_reads_match_reference(step):
    """Noise drawn on each side from the same (seed, step, generation):
    surfaces within the engine bands, comparator products equal except
    at cells whose reference voltage lies in the band around V_tw
    (counted; STCF counts and labels may move only where their 7x7 patch
    holds such a cell)."""
    je, te, jspec, tspec = _pair(_full_spec)
    jo, to = je.read(jspec, 0.04, noise_step=step), te.read(tspec, 0.04,
                                                            step)
    v_tw = torch.full((), te.cfg.v_tw())
    for surf, m, st, band_ulp in (("surface", "mask", "stcf", ANALOG_ULP),
                                  ("s2", "m2", "st2", ANALOG_2D_ULP)):
        ref_v = _t(jo[surf])
        assert _ulp(to[surf], jo[surf]) <= band_ulp
        near = tref.ulp_distance(ref_v, v_tw.expand_as(ref_v)) <= band_ulp
        flips = to[m] != _t(jo[m])
        assert not bool((flips & ~near).any())
        near_p = tref.stcf_support_ref(near, 3, include_self=True) > 0
        moved = to[st] != _t(jo[st])
        assert not bool((moved & ~near_p).any())
        if surf == "surface":
            assert not bool(((to["labels"] != _t(jo["labels"]))
                             & ~near_p).any())
    assert int(torch.isfinite(te.state.surfaces.sae).sum()) > 100


def test_generation_crosses_between_packages():
    """The slot generations (the noise key's second input) carry across
    with the engine state: the port's engine on the JAX engine's state
    draws within the band of the JAX read after a reattach."""
    spec_of = lambda m, f: m.ReadoutSpec(            # noqa: E731
        surface=m.surface(fidelity=f.analog_3d()))
    je, te, jspec, tspec = _pair(spec_of)
    je._detach(1)
    je.attach()
    arrays = {k: np.asarray(v) for k, v in (
        ("surfaces.sae", je.state.surfaces.sae),
        ("surfaces.t_last", je.state.surfaces.t_last),
        ("surfaces.n_events", je.state.surfaces.n_events),
        ("generation", je.state.generation),
        ("cache.tiles", je.state.cache.tiles),
        ("cache.dirty", je.state.cache.dirty))}
    te.load_state(convert.engine_state_from_numpy(arrays, "cpu"))
    assert te.state.generation.tolist() == [1, 2, 1]
    assert _ulp(te.read(tspec, 0.04, 7)["surface"],
                je.read(jspec, 0.04, noise_step=7)["surface"]) <= ANALOG_ULP


# ---------------------------------------------------------------------------
# ISCArray
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["3d", "2d", "ideal"])
def test_isc_array_matches_reference(mode):
    """Write and read in every mode: SAE bitwise, the droop and the read
    within ANALOG_ULP, the comparator mask equal away from V_tw; the
    state crosses to numpy and back unchanged."""
    rng = np.random.default_rng(0)
    n = 300
    ev = dict(x=rng.integers(-1, 33, n).astype(np.int32),
              y=rng.integers(0, 24, n).astype(np.int32),
              t=np.sort(rng.uniform(0, 0.05, n)).astype(np.float32),
              p=rng.integers(0, 2, n).astype(np.int32),
              valid=rng.random(n) < 0.9)
    ja = jisc.ISCArray(24, 32, 2, mode=mode)
    ta = tisc.ISCArray(24, 32, 2, mode=mode, device="cpu")
    js = ja.write(ja.init(jax.random.PRNGKey(3)), jts.EventBatch(
        **{k: jnp.asarray(v) for k, v in ev.items()}))
    ts_ = ta.write(ta.init(prng.PRNGKey(3)), tts.EventBatch(
        **{k: torch.from_numpy(v) for k, v in ev.items()}))
    np.testing.assert_array_equal(ts_.sae.numpy(), np.asarray(js.sae))
    assert _ulp(ts_.droop, js.droop) <= ANALOG_ULP
    v = ta.read(ts_, 0.06)
    ref_v = _t(ja.read(js, 0.06))
    assert _ulp(v, ref_v) <= ANALOG_ULP
    far = tref.ulp_distance(ref_v, torch.full_like(ref_v, ta.v_tw())) > 4
    if mode == "ideal":
        far = torch.ones_like(far)
    assert torch.equal(ta.read_mask(ts_, 0.06)[far],
                       _t(ja.read_mask(js, 0.06))[far])
    back = convert.isc_state_from_numpy(convert.isc_state_to_numpy(ts_),
                                        "cpu")
    assert torch.equal(back.sae, ts_.sae) and torch.equal(back.droop,
                                                          ts_.droop)
    for a, b in zip(back.params, ts_.params):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError):
        tisc.ISCArray(24, 32, mode="4d", device="cpu")


# ---------------------------------------------------------------------------
# the energy model (host floats)
# ---------------------------------------------------------------------------

def _energy_calls():
    yield "isc_array_report", {}
    yield "isc_array_power", {}
    yield "cell_write_energy", dict(cmem_f=15e-15)
    yield "cell_leakage_power", {}
    for name in ("arch_3d", "arch_2d", "sram_array_ref53",
                 "sram_array_ref26", "compare_isc_sram", "compare_2d_3d"):
        yield name, {}


@pytest.mark.parametrize("name, kw", list(_energy_calls()))
def test_energy_model_functions_equal_reference(name, kw):
    got, want = getattr(tem, name)(**kw), getattr(jem, name)(**kw)
    assert type(got).__name__ == type(want).__name__
    if dataclasses.is_dataclass(want):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got == want


@pytest.mark.parametrize("mode", ["ideal", "analog_3d", "analog_2d"])
def test_energy_meter_equals_reference(mode):
    tm, jm = tem.EnergyMeter(h=24, w=32), jem.EnergyMeter(h=24, w=32)
    assert dataclasses.asdict(tm.costs(mode)) == dataclasses.asdict(
        jm.costs(mode))
    assert tm.write_energy_j(mode, 1234) == jm.write_energy_j(mode, 1234)
    assert tm.read_energy_j(mode, 3) == jm.read_energy_j(mode, 3)
    assert tm.leakage_energy_j(mode, 0.015) == jm.leakage_energy_j(mode, 0.015)
    with pytest.raises(ValueError):
        tm.costs("analog_4d")


# ---------------------------------------------------------------------------
# streaming: energy metering, the oracle with noise, the sweep
# ---------------------------------------------------------------------------

def _tiered_analog_feeds():
    head_spec = rs.ReadoutSpec(
        surface=rs.surface(fidelity=fm.analog_3d()),
        stcf=rs.stcf(decay=rs.surface(fidelity=fm.analog_3d())),
        labels=rs.denoise(input="stcf"),
    )
    feeds = rp.mixed_scene_feeds(H, W, 0.06, 4, seed=7, noise_hz=20.0,
                                 churn=True, tiered=True)
    return [dataclasses.replace(f, qos=dataclasses.replace(f.qos,
                                                           spec=head_spec))
            if f.qos.tier == "gesture" else f for f in feeds]


def test_stream_replay_oracle_bitwise_with_noise_and_energy():
    """The reference's acceptance gate on the port: a head-bearing,
    analog-fidelity, per-tier stream under QoS overload replays bitwise
    through the port's synchronous oracle (noise included), and the
    meter attributes write/read/leak energy per tier."""
    primary = rs.ReadoutSpec(surface=rs.surface())

    def make_engine():
        return _engine(n_slots=6, chunk_capacity=1 << 11, specs=(primary,))

    scfg = StreamConfig(policy="drop_oldest", queue_capacity=1 << 12,
                        deadline_s=0.005, step_chunk_budget=3)
    report = rp.replay(make_engine(), _tiered_analog_feeds(), scfg, primary,
                       arrival_substeps=2)
    assert rp.check_oracle(report, make_engine, primary) == report.n_steps > 0
    e = report.energy_uj
    assert min(e["energy_write_uj"], e["energy_read_uj"],
               e["energy_leak_uj"]) > 0
    assert e["energy_total_uj"] == pytest.approx(
        e["energy_write_uj"] + e["energy_read_uj"] + e["energy_leak_uj"])
    tiers = report.tier_energy_uj
    assert set(tiers) == {"gesture", "telemetry"}
    assert sum(r["total_uj"] for r in tiers.values()) == pytest.approx(
        e["energy_total_uj"], rel=1e-6)
    g, t = tiers["gesture"], tiers["telemetry"]
    gi, ti = (report.tiers[k]["ingested"] for k in ("gesture", "telemetry"))
    assert gi > 0 and ti > 0
    assert g["write_uj"] / gi < t["write_uj"] / ti / 10
    assert "modeled energy" in report.summary()


def test_energy_meter_digital_vs_analog_stream():
    """Same traffic, digital vs analog spec: modeled energy per event
    drops by >= 10x (the sweep's headline criterion)."""
    scfg = StreamConfig(policy="drop_oldest", queue_capacity=1 << 12,
                        deadline_s=0.01)
    per_event = {}
    for name, fid in (("ideal", None), ("analog_3d", fm.analog_3d())):
        spec = rs.ReadoutSpec(surface=rs.surface(fidelity=fid))
        report = rp.replay(_engine(n_slots=6, chunk_capacity=1 << 11,
                                   specs=(spec,)),
                           rp.mixed_scene_feeds(H, W, 0.04, 3, seed=5),
                           scfg, spec)
        per_event[name] = report.energy_uj["energy_per_event_nj"]
    assert per_event["ideal"] / per_event["analog_3d"] >= 10


SWEEP_ARGS = dict(hw="24x32", sensors=2, duration=0.02, deadline=0.005,
                  chunk=512, cmem="20", retention="24", classes=2, tol=0.02,
                  energy_factor=10.0, seed=0)


@pytest.fixture(scope="module")
def sweep_pair(tmp_path_factory):
    """``run_sweep`` of both packages at the reference test's grid."""
    from repro.launch.serve import run_sweep as jrun
    from repro_torch.launch.serve import run_sweep as trun

    out = {}
    for name, fn, extra in (("jax", jrun, {}),
                            ("torch", trun, dict(device="cpu"))):
        d = tmp_path_factory.mktemp(name)
        fn(argparse.Namespace(**SWEEP_ARGS, **extra, out=str(d)))
        out[name] = (json.loads((d / "sweep.json").read_text()),
                     (d / "sweep.md").read_text())
    return out


def test_sweep_matches_reference(sweep_pair):
    """The same three verdicts and the same energy rows (modes, grid
    points, events ingested, nJ/event and the ratio to digital, exactly);
    denoise agreement within the comparator band (0.005)."""
    (got, md), (want, _) = sweep_pair["torch"], sweep_pair["jax"]
    assert got["verdicts"] == want["verdicts"]
    assert all(v for k, v in got["verdicts"].items()
               if k != "analog_3d_energy_factor")
    keys = ("cmem_ff", "retention_ms", "mode", "ingested",
            "energy_per_event_nj", "energy_ratio_vs_ideal")
    assert [{k: r[k] for k in keys} for r in got["rows"]] == [
        {k: r[k] for k in keys} for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert abs(g["denoise_agreement"] - w["denoise_agreement"]) <= 5e-3
    assert [r["mode"] for r in got["frontier"]] == [
        r["mode"] for r in want["frontier"]]
    assert "## Frontier" in md and "## Verdicts" in md
