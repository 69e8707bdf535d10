"""The port's offline STCF, ROC and labeled ingest vs the JAX package, on
the CPU.

The same seeded synthetic DND21-like streams go through both packages'
``stcf_reference`` / ``stcf_chunked`` (the JAX side runs as jitted
plain JAX) and both engines' ``push_labeled`` (the JAX engine on
``backend="ref"``).  Bands:

* ideal mode compares stamp differences with the window, no ``exp``:
  supports are bitwise equal;
* eDRAM mode compares ``v_mem(dt) > v_tw``, and the two packages' ``exp``
  may differ by an ULP: supports are equal for every event none of whose
  patch neighbours' ``v_mem(dt)`` lies within 2 ULP of ``v_tw`` (the
  comparator band, counted and bounded below 2 % of events);
* ``roc_curve``: fpr and tpr bitwise, AUC within 1e-6.

Inside the port, ``push_labeled`` equals the offline ``stcf_chunked`` at
``chunk = chunk_capacity`` bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stcf as jstcf
from repro.core import time_surface as jts
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.serve import ts_engine as jeng
from repro_torch.core import edram as tedram
from repro_torch.core import stcf as tstcf
from repro_torch.core import time_surface as tts
from repro_torch.events import aer as taer
from repro_torch.kernels import ref as tref
from repro_torch.serve import ts_engine as teng

jax.config.update("jax_platforms", "cpu")

H, W, CHUNK = 36, 44, 128


def _stream(kind="driving", seed=3, duration=0.03):
    """A seeded stream as (numpy fields padded to a multiple of CHUNK,
    is_signal), packed and unpacked through AER (1 us stamps) as an
    engine would receive it."""
    truth = jdatasets.dnd21_like(kind, H, W, duration, seed=seed)
    s = taer.unpack(jaer.pack(truth), H, W)
    n = s.n + (-s.n) % CHUNK
    pad = n - s.n
    fields = dict(x=np.pad(s.x, (0, pad)).astype(np.int32),
                  y=np.pad(s.y, (0, pad)).astype(np.int32),
                  t=np.pad(s.t, (0, pad)).astype(np.float32),
                  p=np.pad(s.p, (0, pad)).astype(np.int32),
                  valid=np.arange(n) < s.n)
    return fields, np.pad(truth.is_signal, (0, pad))


def _both(fields):
    return (jts.EventBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tts.EventBatch(**{k: torch.from_numpy(v.copy())
                              for k, v in fields.items()}))


def _cfgs(**kw):
    return jstcf.STCFConfig(**kw), tstcf.STCFConfig(**kw)


def _comparator_band(fields, cfg, params, v_tw):
    """Per event: whether any other event of its patch (same polarity
    when polarity-sensitive) that is not later reads within 2 ULP of
    ``v_tw`` at the event's time -- a superset of the cells the serial
    and the chunked STCF compare."""
    ev = {k: torch.from_numpy(v) for k, v in fields.items()}
    dy = ev["y"][:, None] - ev["y"][None, :]
    dx = ev["x"][:, None] - ev["x"][None, :]
    near = (dy.abs() <= cfg.radius) & (dx.abs() <= cfg.radius)
    if cfg.polarity_sensitive:
        near &= ev["p"][:, None] == ev["p"][None, :]
    dt = ev["t"][:, None] - ev["t"][None, :]
    v = tedram.v_mem(dt.clamp_min(0.0), params)
    close = tref.ulp_distance(v, torch.full_like(v, v_tw)) <= 2
    pair = near & (dt >= 0) & ev["valid"][None, :] & close
    pair.fill_diagonal_(False)
    return pair.any(dim=1).numpy()


def _assert_supports(got, want, fields, mode, cfg, params, v_tw):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.int32 and got.shape == want.shape
    if mode == "ideal":
        np.testing.assert_array_equal(got, want)
        return 0
    band = _comparator_band(fields, cfg, params, v_tw)
    assert band.mean() < 0.02
    np.testing.assert_array_equal(got[~band], want[~band])
    return int(band.sum())


def _edram(mode):
    if mode == "ideal":
        return None, None
    p = tedram.decay_params_for_cmem()
    return p, tedram.v_tw_for_window(0.024, p)


@pytest.mark.parametrize("mode", ["ideal", "edram"])
def test_stcf_reference_matches(mode):
    fields, _ = _stream(seed=3, duration=0.02)
    jev, tev = _both(fields)
    jcfg, tcfg = _cfgs(radius=2)
    want, wsig = jstcf.stcf_reference(jev, H, W, jcfg, mode=mode)
    got, gsig = tstcf.stcf_reference(tev, H, W, tcfg, mode=mode)
    params, v_tw = _edram(mode)
    _assert_supports(got, want, fields, mode, tcfg, params, v_tw)
    assert (gsig.numpy() == (got.numpy() >= 2) & fields["valid"]).all()


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("mode", ["ideal", "edram"])
@pytest.mark.parametrize("pol", [False, True])
def test_stcf_chunked_matches(mode, intra, pol):
    fields, _ = _stream(seed=4)
    jev, tev = _both(fields)
    jcfg, tcfg = _cfgs(polarity_sensitive=pol)
    want, _ = jstcf.stcf_chunked(jev, H, W, jcfg, chunk=CHUNK, mode=mode,
                                 intra_chunk=intra)
    got, gsig = tstcf.stcf_chunked(tev, H, W, tcfg, chunk=CHUNK, mode=mode,
                                   intra_chunk=intra)
    params, v_tw = _edram(mode)
    _assert_supports(got, want, fields, mode, tcfg, params, v_tw)
    assert got.shape == (fields["x"].shape[0],)
    assert not gsig.numpy()[~fields["valid"]].any()


def test_stcf_chunked_rejects_ragged_batch():
    fields, _ = _stream(seed=4)
    _, tev = _both(fields)
    cut = tts.EventBatch(*(f[:CHUNK + 1] for f in tev))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tstcf.stcf_chunked(cut, H, W, chunk=CHUNK)


@pytest.mark.parametrize("seed", [5, 6])
def test_roc_curve_matches(seed):
    fields, is_signal = _stream(kind="driving", seed=seed)
    jev, tev = _both(fields)
    sup, _ = tstcf.stcf_chunked(tev, H, W, chunk=CHUNK, mode="edram")
    labels, valid = torch.from_numpy(is_signal), torch.from_numpy(
        fields["valid"])
    jf, jt, jauc = jstcf.roc_curve(jnp.asarray(sup.numpy()),
                                   jnp.asarray(is_signal),
                                   jnp.asarray(fields["valid"]))
    f, t, auc = tstcf.roc_curve(sup, labels, valid)
    np.testing.assert_array_equal(f.numpy().view(np.int32),
                                  np.asarray(jf).view(np.int32))
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  np.asarray(jt).view(np.int32))
    assert abs(float(auc) - float(jauc)) <= 1e-6
    assert 0.5 < float(auc) <= 1.0


def _labeled_engines(mode):
    kw = dict(h=H, w=W, polarities=2, n_slots=2, chunk_capacity=CHUNK,
              mode=mode)
    je = jeng.TimeSurfaceEngine(jeng.TSEngineConfig(**kw, backend="ref"))
    te = teng.TimeSurfaceEngine(teng.TSEngineConfig(**kw), device="cpu")
    return je, te, (je.attach(), je.attach()), (te.attach(), te.attach())


@pytest.mark.parametrize("mode", ["edram", "ideal"])
def test_push_labeled_matches_reference_and_offline(mode):
    je, te, jcams, tcams = _labeled_engines(mode)
    words = [jaer.pack(jdatasets.dnd21_like(k, H, W, 0.03, seed=6 + i))
             for i, k in enumerate(("driving", "hotel_bar"))]
    for jc, tc, wd in zip(jcams, tcams, words):
        jc.push(wd[: len(wd) // 3])          # a surface to label against
        tc.push(wd[: len(wd) // 3])
    cfg = te.cfg
    params, v_tw = cfg.decay_params(), cfg.v_tw()
    for jc, tc, wd in zip(jcams, tcams, words):
        rest = wd[len(wd) // 3:]
        jsup, jsig = jc.push_labeled(rest)
        tsup, tsig = tc.push_labeled(rest)
        assert tsup.dtype == torch.int32 and tsig.dtype == torch.bool
        stream = taer.unpack(rest, H, W)
        fields = dict(x=stream.x, y=stream.y, t=stream.t, p=stream.p,
                      valid=np.ones(stream.n, bool))
        _assert_supports(tsup.numpy(), np.asarray(jsup), fields, mode,
                         cfg.stcf_config(), params, v_tw)
        np.testing.assert_array_equal(
            tsig.numpy(), tsup.numpy() >= cfg.stcf_threshold)
    # the pool state after labeled ingest is the plain push's, bitwise
    np.testing.assert_array_equal(
        te.state.surfaces.sae.numpy().view(np.int32),
        np.asarray(je.state.surfaces.sae).view(np.int32))
    np.testing.assert_array_equal(te.state.surfaces.n_events.numpy(),
                                  np.asarray(je.state.surfaces.n_events))


@pytest.mark.parametrize("mode", ["edram", "ideal"])
def test_push_labeled_equals_offline_stcf_chunked(mode):
    _, te, _, (cam, _) = _labeled_engines(mode)
    words = jaer.pack(jdatasets.dnd21_like("driving", H, W, 0.03, seed=9))
    sup, sig = cam.push_labeled(words)
    stream = taer.unpack(words, H, W)
    n = stream.n + (-stream.n) % CHUNK
    pad = n - stream.n
    ev = tts.EventBatch(*(torch.from_numpy(np.pad(f, (0, pad)).astype(d))
                          for f, d in ((stream.x, np.int32),
                                       (stream.y, np.int32),
                                       (stream.t, np.float32),
                                       (stream.p, np.int32))),
                        valid=torch.arange(n) < stream.n)
    cfg = te.cfg
    off, off_sig = tstcf.stcf_chunked(ev, H, W, cfg.stcf_config(),
                                      chunk=CHUNK, mode=mode,
                                      params=cfg.decay_params(),
                                      v_tw=cfg.v_tw())
    assert sup.shape == (stream.n,) and n > CHUNK
    assert torch.equal(sup, off[:stream.n])
    assert torch.equal(sig, off_sig[:stream.n])
