"""The repro_torch serving engine vs the JAX engine, on the CPU.

Equal ``TSEngineConfig``s in both packages (P=2, a ``count(4)``-bearing
spec declared; the JAX engine on ``backend="ref"``) take the same seeded
packed-AER streams.  State written by the scatter (SAE, ``t_last``,
``n_events``, counts, dirty marks) must be bitwise equal; reads must sit
in the bands of ``test_torch_kernels.py`` (decay <= 2 ULP, masks and
support counts exact away from the threshold, the rest bitwise).  Inside
the port, the cached incremental ``serve_step`` must equal a dense read
bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.serve import spec as jspec
from repro.serve import ts_engine as jeng
from repro_torch import convert
from repro_torch.events import aer as taer
from repro_torch.events import datasets as tdatasets
from repro_torch.kernels import ref as tref
from repro_torch.serve import spec as tspec
from repro_torch.serve import ts_engine as teng

jax.config.update("jax_platforms", "cpu")

H, W, S, CAP = 40, 72, 3, 128


def _cfgs(mode, **extra):
    kw = dict(h=H, w=W, polarities=2, n_slots=S, chunk_capacity=CAP,
              mode=mode, **extra)
    return (jeng.TSEngineConfig(**kw, backend="ref", specs=(
                jspec.ReadoutSpec(count=jspec.Count(4)),)),
            teng.TSEngineConfig(**kw, specs=(
                tspec.ReadoutSpec(count=tspec.Count(4)),)))


def _frame_specs():
    def make(m):
        return m.ReadoutSpec(surface=m.Surface(), mask=m.Mask(),
                             stcf=m.Stcf(), count=m.Count(4), ebbi=m.Ebbi(),
                             sae_raw=m.SaeRaw())
    return make(jspec), make(tspec)


def _words(seed, t_lo=0.0, t_hi=0.06):
    """Packed AER words of a seeded synthetic scene window."""
    kind = ("driving", "hotel_bar")[seed % 2]
    s = jdatasets.dnd21_like(kind, H, W, 0.06, seed=seed)
    words = jaer.pack(s.window(t_lo, t_hi))
    t = tdatasets.dnd21_like(kind, H, W, 0.06, seed=seed)
    assert np.array_equal(taer.pack(t.window(t_lo, t_hi)), words)
    return words


def _engines(mode, **extra):
    jcfg, tcfg = _cfgs(mode, **extra)
    je, te = jeng.TimeSurfaceEngine(jcfg), teng.TimeSurfaceEngine(
        tcfg, device="cpu")
    for _ in range(S):
        je.attach(), te.attach()
    return je, te


def _bits(x):
    return np.asarray(x).view(np.int32)


def _assert_state_equal(je, te):
    js, ts = je.state, te.state
    np.testing.assert_array_equal(_bits(ts.surfaces.sae), _bits(js.surfaces.sae))
    np.testing.assert_array_equal(_bits(ts.surfaces.t_last),
                                  _bits(js.surfaces.t_last))
    for a, b in ((ts.surfaces.n_events, js.surfaces.n_events),
                 (ts.generation, js.generation),
                 (ts.cache.dirty, js.cache.dirty), (ts.counts, js.counts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ulp(a, b):
    return tref.ulp_distance(torch.as_tensor(np.array(a, np.float32)),
                             torch.as_tensor(np.array(b, np.float32)))


def _assert_reads_in_band(jout, tout, v, v_tw, radius):
    """Port products vs the JAX ones; ``v`` is the reference's surface."""
    near = _ulp(v, np.full_like(v, np.float32(v_tw))).numpy() <= 4
    near_patch = tref.stcf_support_ref(torch.from_numpy(near), radius,
                                       include_self=True).numpy() > 0
    assert near_patch.mean() < 1e-3
    for name, got in tout.items():
        want = np.asarray(jout[name])
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "surface":
            assert _ulp(got, want).max() <= 2
        elif name == "mask":
            np.testing.assert_array_equal(got[~near], want[~near])
        elif name == "stcf":
            np.testing.assert_array_equal(got[~near_patch], want[~near_patch])
        else:
            np.testing.assert_array_equal(_bits(got) if got.dtype == np.float32
                                          else got,
                                          _bits(want) if want.dtype == np.float32
                                          else want, err_msg=name)


@pytest.mark.parametrize("mode", ["edram", "ideal"])
def test_push_and_read_match_reference(mode):
    je, te = _engines(mode)
    items = [(s, _words(10 + s)) for s in range(S)]
    je.push(items)
    te.push(items)
    _assert_state_equal(je, te)
    jsp, tsp = _frame_specs()
    t_now = 0.06
    jout, tout = je.read(jsp, t_now), te.read(tsp, t_now)
    assert set(tout) == set(jout)
    _assert_reads_in_band(jout, tout, np.asarray(jout["surface"]),
                          te.cfg.v_tw(), te.cfg.stcf_radius)
    assert abs(te.cfg.v_tw() - je.cfg.v_tw()) <= 1e-6 * abs(je.cfg.v_tw())
    assert tuple(te.cfg.stcf_config()) == tuple(je.cfg.stcf_config())


def test_serve_step_dense_then_incremental(monkeypatch):
    # a gather cap of every tile keeps the second burst incremental
    je, te = _engines("edram", max_dirty_tiles=S * 2 * 5)
    calls = []
    real = teng.ops.ts_fused_dirty

    def spy(*args, **kwargs):
        calls.append(kwargs["force_dense"])
        return real(*args, **kwargs)

    monkeypatch.setattr(teng.ops, "ts_fused_dirty", spy)
    frame_j = jspec.ReadoutSpec(surface=jspec.Surface(), mask=jspec.Mask(),
                                stcf=jspec.Stcf(), count=jspec.Count(4),
                                ebbi=jspec.Ebbi())
    frame_t = tspec.ReadoutSpec(surface=tspec.Surface(), mask=tspec.Mask(),
                                stcf=tspec.Stcf(), count=tspec.Count(4),
                                ebbi=tspec.Ebbi())
    t_now = 0.06
    for lo, hi in ((0.0, 0.03), (0.03, 0.06)):   # dense fill, then cached
        items = [(s, _words(20 + s, lo, hi)) for s in range(S)]
        jout = je.serve_step(items, frame_j, t_now)
        tout = te.serve_step(items, frame_t, t_now)
        _assert_state_equal(je, te)
        _assert_reads_in_band(jout, tout, np.asarray(jout["surface"]),
                              te.cfg.v_tw(), te.cfg.stcf_radius)
        dense = te.read(tspec.SURFACE_SPEC, t_now)["surface"]
        assert torch.equal(tout["surface"].view(torch.int32),
                           dense.view(torch.int32))
    assert calls == [True, False] and te.stats()["cache_t"] == t_now
    # a pure cached read (no items) serves the same bits again
    again = te.serve_step([], frame_t, t_now)["surface"]
    assert torch.equal(again.view(torch.int32),
                       tout["surface"].view(torch.int32))


def test_detach_reattach_and_read_many():
    _, te = _engines("edram")
    sessions = list(te._sessions.values())
    te.push([(s, _words(30 + s)) for s in range(S)])
    victim = sessions[1]
    gen = victim.generation
    victim.detach()
    assert te.n_live == S - 1
    with pytest.raises(RuntimeError, match="detached"):
        victim.push(_words(1))
    fresh = te.attach()
    assert fresh.slot == 1 and fresh.generation == gen + 1
    st = te.state
    assert torch.isneginf(st.surfaces.sae[1]).all()
    assert st.surfaces.n_events[1] == 0 and st.counts[1].sum() == 0
    assert not st.cache.dirty[1].any() and st.surfaces.t_last[1] == 0.0
    a = tspec.ReadoutSpec(surface=tspec.Surface(), ebbi=tspec.Ebbi())
    b = tspec.ReadoutSpec(ebbi=tspec.Ebbi(), surface=tspec.Surface())
    c = tspec.ReadoutSpec(stcf=tspec.Stcf())
    out = te.read_many([a, c, b], 0.06)
    assert list(out) == [a, c]           # a == b: read once
    for sp, products in out.items():
        for name, v in te.read(sp, 0.06).items():
            assert torch.equal(products[name], v)
    one = sessions[0].read(c, 0.06)["stcf"]
    assert torch.equal(one, out[c]["stcf"][0])


def test_state_carried_over_from_reference():
    je, te = _engines("edram")
    je.push([(s, _words(40 + s, 0.0, 0.03)) for s in range(S)])
    arrays = {
        "surfaces.sae": je.state.surfaces.sae,
        "surfaces.t_last": je.state.surfaces.t_last,
        "surfaces.n_events": je.state.surfaces.n_events,
        "generation": je.state.generation,
        "cache.tiles": je.state.cache.tiles,
        "cache.dirty": je.state.cache.dirty,
        "counts": je.state.counts,
    }
    te.load_state(convert.engine_state_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu"))
    assert te.stats()["cache_t"] is None
    items = [(s, _words(40 + s, 0.03, 0.06)) for s in range(S)]
    je.push(items)
    te.push(items)
    _assert_state_equal(je, te)
    back = convert.engine_state_to_numpy(te.state)
    np.testing.assert_array_equal(back["surfaces.sae"].view(np.int32),
                                  _bits(je.state.surfaces.sae))
    params = convert.decay_params_from_numpy(je.cfg.decay_params(), "cpu")
    assert all(np.float32(a) == b for a, b in zip(je.cfg.decay_params(),
                                                   params))


def test_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.TimeSurfaceEngine(_cfgs("edram")[1])


def _planes():
    """Seeded (4, 5) per-cell planes of the reference's eDRAM decay
    parameters (a1, tau1, a2, tau2, b), as numpy float32."""
    rng = np.random.default_rng(8)
    base = _cfgs("edram")[0].decay_params()
    return tuple((np.float32(v) * (1 + 0.05 * rng.standard_normal((4, 5))))
                 .astype(np.float32) for v in base)


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core import isc_array, prng
    from repro_torch.events import replay
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.stream import StreamRuntime
    from repro_torch.core import time_surface as tts
    from repro_torch.events import pipeline as tpipe
    from repro_torch.models import module, transformer
    from repro_torch.serve import engine, heads

    cfg = get_config("mamba2-2.7b").reduced()
    stream = tdatasets.dnd21_like("hotel_bar", 4, 5, 0.01, seed=0)
    head, ecfg = tspec.Classify(n_classes=3, width=8), _cfgs("edram")[1]
    return {
        "empty_sae": lambda: tts.empty_sae(4, 5, 2),
        "surface_init": lambda: tts.surface_init(4, 5, 2),
        "init_params": lambda: module.init_params(
            transformer.param_defs(cfg), torch.Generator()),
        "init_decode_caches": lambda: transformer.init_decode_caches(
            cfg, 1, 8),
        "ServeEngine": lambda: engine.ServeEngine(cfg, {}),
        "to_event_batch": lambda: tpipe.to_event_batch(stream, 16),
        "window_chunks": lambda: tpipe.window_chunks(stream, 0.005, 16),
        "decay_params_from_numpy": lambda: convert.decay_params_from_numpy(
            _planes()),
        "resolve_head_params": lambda: heads.resolve_head_params(
            head, ecfg),
        "head_params_from_numpy": lambda: convert.head_params_from_numpy(
            convert.head_params_to_numpy(heads.resolve_head_params(
                head, ecfg, "cpu")), head, ecfg),
        "StreamRuntime": lambda: StreamRuntime(teng.TimeSurfaceEngine(ecfg)),
        "replay": lambda: replay.replay(
            teng.TimeSurfaceEngine(ecfg),
            replay.mixed_scene_feeds(8, 8, 0.01, 1)),
        "stream_cli": lambda: launch_serve.main(
            ["stream", "--hw", "8x8", "--sensors", "1", "--duration", "0.01"]),
        "sweep_cli": lambda: launch_serve.main(
            ["sweep", "--hw", "8x8", "--sensors", "1", "--duration", "0.01",
             "--cmem", "20", "--retention", "24"]),
        "ISCArray": lambda: isc_array.ISCArray(4, 5),
        "isc_state_from_numpy": lambda: convert.isc_state_from_numpy(
            convert.isc_state_to_numpy(isc_array.ISCArray(
                4, 5, device="cpu").init(prng.PRNGKey(0)))),
    }


@pytest.mark.parametrize("entry", ["empty_sae", "surface_init", "init_params",
                                   "init_decode_caches", "ServeEngine",
                                   "to_event_batch", "window_chunks",
                                   "decay_params_from_numpy",
                                   "resolve_head_params",
                                   "head_params_from_numpy", "StreamRuntime",
                                   "replay", "stream_cli", "sweep_cli",
                                   "ISCArray", "isc_state_from_numpy"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device named, an entry point allocates on the CUDA device
    and raises when there is none (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()


def test_decay_params_from_numpy_on_cpu():
    """Planes land on the named device bitwise equal to the reference's
    arrays; 0-d values stay float32 host scalars."""
    planes = _planes()
    got = convert.decay_params_from_numpy(planes, device="cpu")
    for a, b in zip(planes, got):
        assert b.device.type == "cpu" and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy().view(np.int32), a.view(np.int32))
    mixed = convert.decay_params_from_numpy(
        (planes[0],) + tuple(_cfgs("edram")[0].decay_params())[1:], "cpu")
    assert isinstance(mixed[0], torch.Tensor)
    assert all(type(x) is np.float32 for x in mixed[1:])


def test_offline_sae_update_out_of_range_matches_reference():
    """Five events off the (2, 4, 5) SAE -- x=-1, y=-1, p=-1, x=5, x=-6 --
    into both packages' offline ``sae_update``, bitwise: an index in
    [-dim, 0) wraps, as the reference's ``.at[].max(mode="drop")`` wraps
    it, and the rest drop."""
    import jax.numpy as jnp

    from repro.core import time_surface as jts
    from repro_torch.core import time_surface as tts

    ev = dict(x=np.array([-1, 0, 0, 5, -6], np.int32),
              y=np.array([0, -1, 0, 0, 0], np.int32),
              t=np.array([0.1, 0.2, 0.3, 0.4, 0.5], np.float32),
              p=np.array([0, 1, -1, 0, 1], np.int32),
              valid=np.ones(5, bool))
    want = jts.sae_update(jts.empty_sae(4, 5, 2), jts.EventBatch(
        **{k: jnp.asarray(v) for k, v in ev.items()}))
    got = tts.sae_update(tts.empty_sae(4, 5, 2, device="cpu"), tts.EventBatch(
        **{k: torch.from_numpy(v) for k, v in ev.items()}))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert int(np.isfinite(np.asarray(want)).sum()) == 3


def test_unported_products_raise():
    """What is still not ported raises, naming its ROADMAP item: the
    fleet features (elastic pools, live migration) of the engine.  The
    analog-fidelity reads that raised here before are served now
    (``tests/test_torch_fidelity.py`` holds them against the reference);
    an analog read returns a surface."""
    from repro_torch.serve import fidelity

    _, te = _engines("edram")
    analog = tspec.ReadoutSpec(surface=tspec.Surface(
        fidelity=fidelity.FidelityModel("analog_3d")))
    assert te.read(analog, 0.01)["surface"].shape == (S, 2, H, W)
    for call in (lambda: te.grow(2 * S), lambda: te.shrink(1),
                 lambda: te.migrate(0, 1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
