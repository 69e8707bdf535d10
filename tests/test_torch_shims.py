"""The port's deprecated shims and oracles vs their reference twins, on the
CPU.

* The engine's method-per-feature shims (``acquire`` / ``release`` /
  ``ingest`` / ``readout`` / ``readout_with_mask`` / ``support_map`` /
  ``ingest_and_read``): the three cases of ``test_deprecation_shims.py``
  on the port -- one warning per engine and name, values bitwise the
  session/spec twin's, ``release`` validating -- on one device and on
  ``make_host_mesh(1 | 2, device="cpu")``; then each shim against the
  reference engine's shim on the same streams (the reference on
  ``backend="interpret"``, as its own shim tests run it): SAE, masks and
  supports bitwise, surfaces within 2 ULP (the reference's
  cross-backend bar).
* ``spec.read_products``: warns once per process, equals
  ``read_compiled`` and the engine's read bitwise, and the reference's
  ``read_products`` in the same bands; a backend string passed
  positionally raises ``TypeError``.
* ``spec.Stcf.from_config``, ``kernels.ref.ts_fused_ref`` (negative,
  past-the-end, duplicate and -inf-time events) and
  ``events.pipeline._window_chunks_reference`` against the reference's.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edram as jedram
from repro.core import stcf as jstcf
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.events import pipeline as jpipeline
from repro.kernels import ref as jref
from repro.serve import spec as jspec
from repro.serve import ts_engine as jeng
from repro_torch.core import edram as tedram
from repro_torch.core import stcf as tstcf
from repro_torch.core import time_surface as tts
from repro_torch.events import aer as taer
from repro_torch.events import datasets as tdatasets
from repro_torch.events import pipeline as tpipeline
from repro_torch.events import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import spec as tspec
from repro_torch.serve import ts_engine as teng
from repro_torch.serve.api import pool_items

jax.config.update("jax_platforms", "cpu")

H, W = 48, 64
SHARDS = pytest.mark.parametrize("shards", [0, 1, 2],
                                 ids=["single", "mesh1", "mesh2"])

pytestmark = pytest.mark.filterwarnings("always::DeprecationWarning")


def _kw():
    return dict(h=H, w=W, n_slots=3, chunk_capacity=512, mode="edram")


def _engine(shards):
    mesh = make_host_mesh(shards, device="cpu") if shards else None
    return teng.TimeSurfaceEngine(teng.TSEngineConfig(**_kw()), device="cpu",
                                  mesh=mesh)


def _stream(seed=0, kind="hotel_bar"):
    return tdatasets.dnd21_like(kind, h=H, w=W, duration=0.06, seed=seed)


def _deprecations(rec):
    return [str(r.message) for r in rec
            if issubclass(r.category, DeprecationWarning)]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _t_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _ulp(a, b) -> int:
    return int(tref.ulp_distance(torch.as_tensor(np.asarray(a, np.float32)),
                                 torch.as_tensor(np.asarray(b, np.float32))
                                 ).max())


# -- the reference's three shim cases, on the port --------------------------

@SHARDS
def test_each_shim_warns_exactly_once(shards):
    eng = _engine(shards)
    calls = {
        "acquire": lambda: eng.acquire(),
        "ingest": lambda: eng.ingest([(0, _stream(seed=1))]),
        "readout": lambda: eng.readout(0.08),
        "readout_with_mask": lambda: eng.readout_with_mask(0.08),
        "support_map": lambda: eng.support_map(0.08),
        "ingest_and_read": lambda: eng.ingest_and_read([], 0.08),
        "release": lambda: eng.release(0),
    }
    for name, call in calls.items():
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            call()
            msgs = _deprecations(rec)
            assert len(msgs) == 1, (name, msgs)
            assert name in msgs[0], (name, msgs[0])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if name == "acquire":       # a second call needs a free slot;
                s = eng.acquire()       # detach through the session so the
                eng._sessions[s].detach()   # release shim stays unwarned
            elif name == "release":     # slot 0 must be live again
                assert eng.attach().slot == 0
                call()
            else:
                call()
            assert not _deprecations(rec), (name, "warned twice")
    fresh = _engine(shards)      # per-engine grace, not process-global
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fresh.acquire()
    assert len(_deprecations(rec)) == 1


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@SHARDS
def test_shim_values_bit_identical_to_session_spec_path(shards):
    """Old-name calls on one engine vs session/spec calls on a twin fed
    the same streams: every output matches bitwise."""
    old, new = _engine(shards), _engine(shards)
    streams = [_stream(seed=i, kind="driving" if i % 2 else "hotel_bar")
               for i in range(3)]
    words = [taer.pack(s) for s in streams]

    slots = [old.acquire() for _ in range(2)]
    cams = [new.attach() for _ in range(2)]
    assert slots == [c.slot for c in cams]

    old.ingest(list(zip(slots, words[:2])))
    for cam, w in zip(cams, words[:2]):
        cam.push(w)

    def eq(a, b):
        assert torch.equal(_t_bits(a), _t_bits(b))

    eq(old.readout(0.08), new.read(tspec.SURFACE_SPEC, 0.08)["surface"])
    v_o, m_o = old.readout_with_mask(0.08)
    both = new.read(tspec.ReadoutSpec(surface=tspec.surface(),
                                      mask=tspec.mask()), 0.08)
    eq(v_o, both["surface"])
    eq(m_o, both["mask"])
    eq(old.support_map(0.08),
       new.read(tspec.ReadoutSpec(stcf=tspec.stcf()), 0.08)["stcf"])

    # fused path: dense fill then incremental, both epochs
    for t_now in (0.08, 0.08, 0.1):
        got = old.ingest_and_read([(slots[0], words[2])], t_now)
        want = new.serve_step(pool_items([(cams[0], words[2])]),
                              tspec.SURFACE_SPEC, t_now)["surface"]
        eq(got, want)

    # labeling path
    (sup_o, sig_o), = old.ingest([(slots[1], streams[1])], with_support=True)
    sup_n, sig_n = cams[1].push_labeled(streams[1])
    eq(sup_o, sup_n)
    eq(sig_o, sig_n)

    # lifecycle parity: release == detach (wipe, no generation bump)
    old.release(slots[1])
    cams[1].detach()
    eq(old.readout(0.08), new.read(tspec.SURFACE_SPEC, 0.08)["surface"])
    assert old.n_live == new.n_live == 1
    assert old.acquire() == new.attach().slot


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@SHARDS
def test_release_validates_like_before(shards):
    eng = _engine(shards)
    slot = eng.acquire()
    eng.release(slot)
    with pytest.raises(ValueError):
        eng.release(slot)                  # double release
    with pytest.raises(ValueError):
        eng.release(99)                    # out of range
    with pytest.raises(ValueError):
        eng.ingest([(slot, _stream())])    # free slot


# -- each shim against the reference engine's --------------------------------

def _ref_engine():
    return jeng.TimeSurfaceEngine(jeng.TSEngineConfig(**_kw(),
                                                      backend="interpret"))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@SHARDS
def test_shims_match_reference_engine(shards):
    je, te = _ref_engine(), _engine(shards)
    streams = [_stream(seed=i, kind="driving" if i % 2 else "hotel_bar")
               for i in range(3)]
    words = [taer.pack(s) for s in streams]
    for i, w in enumerate(words):
        kind = "driving" if i % 2 else "hotel_bar"
        assert np.array_equal(jaer.pack(jdatasets.dnd21_like(
            kind, h=H, w=W, duration=0.06, seed=i)), w)
    n = je.capacity

    def sae_equal():
        np.testing.assert_array_equal(
            _bits(te.gather_state().surfaces.sae[:n].numpy()),
            _bits(je.state.surfaces.sae))

    def close(got, want):
        assert _ulp(got[:n].numpy(), np.asarray(want)) <= 2

    def equal(got, want):
        np.testing.assert_array_equal(np.asarray(got)[:n], np.asarray(want))

    jslots = [je.acquire() for _ in range(2)]
    tslots = [te.acquire() for _ in range(2)]
    assert jslots == tslots
    je.ingest(list(zip(jslots, words[:2])))
    te.ingest(list(zip(tslots, words[:2])))
    sae_equal()
    close(te.readout(0.08), je.readout(0.08))
    (tv, tm), (jv, jm) = te.readout_with_mask(0.08), je.readout_with_mask(0.08)
    close(tv, jv)
    equal(tm, jm)
    equal(te.support_map(0.08), je.support_map(0.08))
    for t_now in (0.08, 0.08, 0.1):
        close(te.ingest_and_read([(tslots[0], words[2])], t_now),
              je.ingest_and_read([(jslots[0], words[2])], t_now))
        sae_equal()
    (tsup, tsig), = te.ingest([(tslots[1], words[1])], with_support=True)
    (jsup, jsig), = je.ingest([(jslots[1], words[1])], with_support=True)
    np.testing.assert_array_equal(tsup.numpy(), jsup)
    np.testing.assert_array_equal(tsig.numpy(), jsig)
    sae_equal()
    te.release(tslots[1])
    je.release(jslots[1])
    sae_equal()
    close(te.readout(0.1), je.readout(0.1))
    assert te.n_live == je.n_live == 1
    assert te.acquire() == je.acquire()


# -- read_products -----------------------------------------------------------

def _read_spec(m):
    return m.ReadoutSpec(surface=m.surface(), mask=m.mask(), stcf=m.stcf(),
                         labels=m.denoise())


def test_read_products_warns_once_and_is_value_identical():
    te, je = _engine(0), _ref_engine()
    words = [taer.pack(_stream(seed=8 + i)) for i in range(3)]
    te.push([(te.attach(), w) for w in words])
    je.push([(je.attach(), w) for w in words])
    spec, cfg = _read_spec(tspec), te.cfg
    dynamic = tspec.resolve_dynamic(spec, cfg)
    statics = tspec.resolve_static(spec, cfg)
    sae = te.state.surfaces.sae
    tspec._read_products_warned = False
    with pytest.warns(DeprecationWarning, match="read_products"):
        out = tspec.read_products(sae, None, 0.05, dynamic, spec, cfg,
                                  statics=statics)
    with warnings.catch_warnings():                   # second call: silent
        warnings.simplefilter("error")
        out2 = tspec.read_products(sae, None, 0.05, dynamic, spec, cfg,
                                   statics=statics)
    staged = tspec.read_compiled(sae, None, 0.05,
                                 tspec.compile_spec(spec, cfg), cfg)
    read = te.read(spec, 0.05)
    assert list(out) == list(spec.names)
    for name in spec.names:
        for want in (staged[name], read[name], out2[name]):
            assert torch.equal(_t_bits(out[name]), _t_bits(want)), name

    jsp = _read_spec(jspec)
    jspec._read_products_warned = True                # silence the twin
    jout = jspec.read_products(
        je.state.surfaces.sae, None, jnp.float32(0.05),
        jspec.resolve_dynamic(jsp, je.cfg), jsp, je.cfg, "interpret",
        jspec.resolve_static(jsp, je.cfg))
    assert _ulp(out["surface"].numpy(), np.asarray(jout["surface"])) <= 2
    for name in ("mask", "stcf", "labels"):
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(jout[name]), err_msg=name)

    # the reference's backend argument is gone: passed positionally, it
    # is refused rather than taken for the statics
    with pytest.raises(TypeError):
        tspec.read_products(sae, None, 0.05, dynamic, spec, cfg,
                            "interpret", statics)


@pytest.mark.parametrize("kw", [dict(), dict(radius=2, tau_tw=0.01,
                                             include_self=True),
                                dict(radius=1, threshold=4,
                                     polarity_sensitive=True)])
def test_stcf_from_config_matches_reference(kw):
    got = tspec.Stcf.from_config(tstcf.STCFConfig(**kw))
    want = jspec.Stcf.from_config(jstcf.STCFConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == tspec.Stcf(radius=got.radius, tau_tw=got.tau_tw,
                             include_self=got.include_self)


# -- ts_fused_ref ------------------------------------------------------------

T_NOW = 0.1


def _fused_inputs(seed, p=2, h=24, w=40, n=900):
    """An SAE and (N,) events: ~10 % with coordinates outside the plane
    or the polarity range (negative and past the end), ~10 % with -inf
    times (invalid, pre-masked), many on shared cells."""
    rng = np.random.default_rng(seed)
    sae = rng.uniform(0.0, T_NOW, (p, h, w)).astype(np.float32)
    sae[rng.random(sae.shape) < 0.4] = -np.inf
    x = rng.integers(-3, w + 3, n).astype(np.int32)
    y = rng.integers(-3, h + 3, n).astype(np.int32)
    pp = rng.integers(-1, p + 1, n).astype(np.int32)
    inside = rng.random(n) < 0.8
    x[inside] %= w
    y[inside] %= h
    pp[inside] %= p
    hot = rng.random(n) < 0.3                     # duplicates on few cells
    x[hot], y[hot] = x[hot] % 4, y[hot] % 3
    t = rng.uniform(0.0, T_NOW, n).astype(np.float32)
    t[rng.random(n) < 0.1] = -np.inf
    return sae, x, y, pp, t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["edram", "edram+mask"])
def test_ts_fused_ref_matches_reference(seed, mode):
    sae, x, y, p, t = _fused_inputs(seed)
    v_tw = (tedram.v_tw_for_window(0.024, tedram.decay_params_for_cmem())
            if mode == "edram+mask" else None)
    got = tref.ts_fused_ref(torch.from_numpy(sae), torch.from_numpy(x),
                            torch.from_numpy(y), torch.from_numpy(p),
                            torch.from_numpy(t), T_NOW,
                            tedram.decay_params_for_cmem(), v_tw=v_tw)
    want = jref.ts_fused_ref(jnp.asarray(sae), jnp.asarray(x),
                             jnp.asarray(y), jnp.asarray(p), jnp.asarray(t),
                             T_NOW, jedram.decay_params_for_cmem(),
                             v_tw=None if v_tw is None else np.float32(v_tw))
    assert len(got) == len(want)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    assert not np.array_equal(_bits(want[0]), _bits(sae))   # it wrote
    assert _ulp(got[1].numpy(), np.asarray(want[1])) <= 2
    if v_tw is not None:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the oracle of the chunk_scatter -> ts_decay pair, bitwise
    ev = tts.EventBatch(*(torch.from_numpy(f)[None] for f in (
        x, y, t, p, np.ones(len(x), bool))))
    new = torch.from_numpy(sae)[None].clone()
    tops.chunk_scatter_(new, torch.zeros(1, dtype=torch.int32), ev)
    assert torch.equal(_t_bits(new[0]), _t_bits(got[0]))
    assert torch.equal(
        _t_bits(tops.ts_decay(new[0], T_NOW, tedram.decay_params_for_cmem())),
        _t_bits(got[1]))


# -- _window_chunks_reference ------------------------------------------------

@pytest.mark.parametrize("seed,cap,win", [(0, 64, 0.02), (1, 9, 0.007),
                                          (2, 4096, 0.05), (3, 32, 0.02)])
def test_window_chunks_reference_matches_reference(seed, cap, win):
    kind = "driving" if seed % 2 else "hotel_bar"
    if seed == 3:           # the empty stream: one all-padding window
        z = np.zeros(0)
        ts_ = tsyn.EventStream(x=z.astype(np.int32), y=z.astype(np.int32),
                               t=z.astype(np.float32), p=z.astype(np.int32),
                               is_signal=z.astype(bool), h=8, w=8)
        js = jdatasets.syn.EventStream(**{f: getattr(ts_, f) for f in (
            "x", "y", "t", "p", "is_signal", "h", "w")})
    else:
        ts_ = tdatasets.dnd21_like(kind, h=32, w=48, duration=0.06, seed=seed)
        js = jdatasets.dnd21_like(kind, h=32, w=48, duration=0.06, seed=seed)
    got = tpipeline._window_chunks_reference(ts_, win, cap, device="cpu")
    fast = tpipeline.window_chunks(ts_, win, cap, device="cpu")
    want = jpipeline._window_chunks_reference(js, win, cap)
    for f in ("x", "y", "t", "p", "valid"):
        g, w_ = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w_.dtype and g.shape == w_.shape, f
        np.testing.assert_array_equal(_bits(g), _bits(w_), err_msg=f)
        assert torch.equal(getattr(fast, f), getattr(got, f)), f
