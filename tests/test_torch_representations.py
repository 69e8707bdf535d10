"""The port's offline time-surface reads and Sec. II-B representations vs
the JAX package, on the CPU.

The same seeded event batch (AER stamps, so on a 1 us grid) goes through
both packages.  Bands: SAE, counters, EBBI and the ideal window mask
bitwise (max, counts and exact float32 differences); decay reads within
2 ULP (the two ``exp``s); the eDRAM window mask exact away from cells
within 4 ULP of ``v_tw``; ``local_memory_ts`` within rtol 1e-5 (its
scatter-add sums a pixel's events in another order).  The offline frame
paths ``events_to_frames`` and ``streaming_ts``, ideal and eDRAM with
uniform parameters or per-cell planes: eDRAM frames within 2 ULP, ideal
ones within 4 (the reference's ``lax.scan`` is compiled, and XLA turns
its division by the constant ``tau`` into a product with the float32
reciprocal: one more rounding in the exponent), the cells never written
(SAE -inf) reading 0 in both.
``ts_sram_quantized`` reads within 2 ULP of the reference's oracle
``ref.ts_wrapped_read_ref`` on the reference's stored stamps wherever the
two packages store the same wrapped stamp (the reference's own read goes
through its interpret backend, ROADMAP queue 3's fault).  They store
different stamps only where the reference's eager quantizer (a division
by ``tick``) and its compiled ``ts_quantize_sae`` (a product with the
float32 reciprocal, which the port follows) floor to different ticks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edram as jedram
from repro.core import representations as jrep
from repro.core import time_surface as jts
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.events import pipeline as jpipe
from repro.kernels import ref as jref
from repro_torch.core import edram as tedram
from repro_torch.core import representations as trep
from repro_torch.core import time_surface as tts
from repro_torch.events import pipeline as tpipe
from repro_torch.kernels import ref as tref

jax.config.update("jax_platforms", "cpu")

H, W = 30, 41
T_READ = 0.05


def _stream(seed):
    """A seeded stream with AER stamps (on a 1 us grid)."""
    s = jdatasets.dnd21_like("driving", H, W, T_READ, seed=seed)
    return jaer.unpack(jaer.pack(s), H, W)


def _batch(seed=2, n_pad=37):
    """A seeded stream (AER stamps), padded with invalid events, in both
    packages' EventBatch."""
    s = _stream(seed)
    pad = lambda a, d: np.pad(a.astype(d), (0, n_pad))
    f = dict(x=pad(s.x, np.int32), y=pad(s.y, np.int32),
             t=pad(s.t, np.float32), p=pad(s.p, np.int32),
             valid=np.arange(s.n + n_pad) < s.n)
    return (jts.EventBatch(**{k: jnp.asarray(v) for k, v in f.items()}),
            tts.EventBatch(**{k: torch.from_numpy(v.copy())
                              for k, v in f.items()}))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _ulp(a, b):
    return int(tref.ulp_distance(torch.as_tensor(np.array(a)),
                                 torch.as_tensor(np.array(b))).max())


@pytest.mark.parametrize("pols", [1, 2])
def test_surface_update_and_reads_match_reference(pols):
    jev, tev = _batch()
    jstate = jts.surface_update(jts.surface_init(H, W, pols), jev)
    tstate = tts.surface_update(tts.surface_init(H, W, pols, "cpu"), tev)
    for a, b in zip(tstate, jstate):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    jp, tp = jedram.decay_params_for_cmem(), tedram.decay_params_for_cmem()
    assert _ulp(tts.surface_read(tstate, T_READ, tau=0.01),
                jts.surface_read(jstate, T_READ, tau=0.01)) <= 2
    assert _ulp(tts.surface_read(tstate, T_READ, params=tp),
                jts.surface_read(jstate, T_READ, params=jp)) <= 2
    with pytest.raises(ValueError, match="tau"):
        tts.surface_read(tstate, T_READ)
    np.testing.assert_array_equal(
        tts.window_mask_ideal(tstate.sae, T_READ, 0.024).numpy(),
        np.asarray(jts.window_mask_ideal(jstate.sae, T_READ, 0.024)))
    v_tw = tedram.v_tw_for_window(0.024, tp)
    v = tts.ts_edram(tstate.sae, T_READ, tp)
    far = (tref.ulp_distance(v, torch.full_like(v, v_tw)) > 4).numpy()
    np.testing.assert_array_equal(
        tts.window_mask_edram(tstate.sae, T_READ, tp, v_tw).numpy()[far],
        np.asarray(jts.window_mask_edram(jstate.sae, T_READ, jp,
                                         v_tw))[far])


def test_representations_match_reference():
    jev, tev = _batch(seed=3)
    for name in ("event_count", "ebbi"):
        np.testing.assert_array_equal(
            _bits(getattr(trep, name)(tev, H, W).numpy()),
            _bits(getattr(jrep, name)(jev, H, W)), err_msg=name)
    np.testing.assert_array_equal(_bits(trep.sae(tev, H, W, 2).numpy()),
                                  _bits(jrep.sae(jev, H, W, 2)))
    assert _ulp(trep.ts_exponential(tev, H, W, T_READ, 0.01, 2),
                jrep.ts_exponential(jev, H, W, T_READ, 0.01, 2)) <= 2
    np.testing.assert_allclose(
        trep.local_memory_ts(tev, H, W, T_READ, 0.01, 2, chunk=256).numpy(),
        np.asarray(jrep.local_memory_ts(jev, H, W, T_READ, 0.01, 2,
                                        chunk=256)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_bits, tick", [(8, 1e-4), (16, 1e-3)])
def test_ts_sram_quantized_matches_reference(n_bits, tick):
    jev, tev = _batch(seed=4)
    got = trep.ts_sram_quantized(tev, H, W, T_READ, 0.01, n_bits, tick)
    # each package's stored SAE, as its quantizer wrote it
    div = jev._replace(t=(jnp.floor(jev.t / tick).astype(jnp.uint32)
                          % 2 ** n_bits).astype(jnp.float32) * tick)
    jstored = np.array(jts.sae_update(jts.empty_sae(H, W), div))
    want = np.array(jref.ts_wrapped_read_ref(jnp.asarray(jstored), T_READ,
                                             0.01, n_bits=n_bits, tick=tick))
    tstored = tts.sae_update(tts.empty_sae(H, W, 1, "cpu"), tev._replace(
        t=tref.quantize_stamps(tev.t, n_bits, tick))).numpy()
    same = _bits(jstored) == _bits(tstored)
    assert _ulp(got.numpy()[same], want[same]) <= 2
    assert same.mean() > 0.95
    # every other cell holds a stamp the two quantizers floor apart
    t = np.asarray(jev.t)[np.asarray(jev.valid)]
    t32 = np.float32(tick)
    apart = np.floor(t / t32) != np.floor(t * (np.float32(1) / t32))
    assert (~same).sum() == 0 or apart.any()


def _decay(form):
    """Both packages' decay params: None (ideal), uniform, or (1, H, W)
    per-cell planes drawn with numpy."""
    if form == "ideal":
        return None, None
    if form == "edram":
        return jedram.decay_params_for_cmem(), tedram.decay_params_for_cmem()
    base = tedram.decay_params_for_cmem()
    eps = 1 + 0.1 * np.random.default_rng(7).standard_normal((1, H, W))
    planes = [np.full((1, H, W), v, np.float32) for v in base]
    planes[1] = (planes[1] / eps).astype(np.float32)
    planes[3] = (planes[3] / eps).astype(np.float32)
    return (jedram.DecayParams(*map(jnp.asarray, planes)),
            tedram.DecayParams(*(torch.from_numpy(p) for p in planes)))


def _assert_frames(got, want, never, form):
    """The form's ULP band everywhere; exactly 0 in both where the SAE
    was never written."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _ulp(got, want) <= (4 if form == "ideal" else 2)
    assert (got[never] == 0).all() and (want[never] == 0).all()


@pytest.mark.parametrize("form", ["ideal", "edram", "planes"])
@pytest.mark.parametrize("pols", [1, 2])
def test_events_to_frames_matches_reference(form, pols):
    jev, tev = _batch(seed=5)
    jp, tp = _decay(form)
    t_starts = np.array([0.0, 0.012, 0.02, 0.04], np.float32)
    want = jts.events_to_frames(jev, H, W, jnp.asarray(t_starts), 0.01, 0.024,
                                pols, jp)
    got = tts.events_to_frames(tev, H, W, torch.from_numpy(t_starts), 0.01,
                               0.024, pols, tp)
    assert got.shape == (4, pols, H, W)
    sae = [np.asarray(jts.sae_update(jts.empty_sae(H, W, pols), jev._replace(
        valid=jev.valid & (jev.t < t + np.float32(0.01))))) for t in t_starts]
    _assert_frames(got, want, np.stack(sae) == -np.inf, form)


@pytest.mark.parametrize("form", ["ideal", "edram", "planes"])
@pytest.mark.parametrize("pols", [1, 2])
def test_streaming_ts_matches_reference(form, pols):
    s = _stream(6)
    window = 0.01
    jchunks = jpipe.window_chunks(s, window, 4096)
    tchunks = tpipe.window_chunks(s, window, 4096, device="cpu")
    k = jchunks.x.shape[0]
    assert int(tchunks.valid.sum()) == s.n   # no window overflowed
    reads = ((np.arange(k) + 1.0) * window).astype(np.float32)
    jp, tp = _decay(form)
    want = jts.streaming_ts(jchunks, H, W, jnp.asarray(reads), 0.024, pols, jp)
    got = tts.streaming_ts(tchunks, H, W, torch.from_numpy(reads), 0.024,
                           pols, tp)
    assert got.shape == (k, pols, H, W)
    state = jts.surface_init(H, W, pols)
    never = []
    for i in range(k):
        state = jts.surface_update(state, jts.EventBatch(
            *(f[i] for f in jchunks)))
        never.append(np.asarray(state.sae) == -np.inf)
    _assert_frames(got, want, np.stack(never), form)
    # each event written once: the last frame is the read of the whole
    # stream's SAE (the reference's own case, tests/test_core.py)
    whole = tts.sae_update(tts.empty_sae(H, W, pols, "cpu"),
                           tpipe.to_event_batch(s, device="cpu"))
    last = (tts.ts_ideal(whole, reads[-1], 0.024) if tp is None
            else tts.ts_edram(whole, reads[-1], tp))
    assert torch.equal(got[-1], last)
