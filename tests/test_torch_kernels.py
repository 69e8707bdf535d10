"""repro_torch kernel entries vs the JAX reference, on CPU tensors.

Each ``repro_torch.kernels.ops`` entry gets the same seeded numpy inputs
as its ``repro.kernels.ops`` counterpart (run through ``backend="ref"``,
plus one tiny ``backend="interpret"`` case per kernel).  On the CPU the
port runs its plain PyTorch versions, the ones the CUDA kernels are held
to on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Bands:
  * decay reads <= 2 ULP (the reference's own cross-backend bar; both
    sides compute IEEE float32 but with different ``exp``
    implementations), never-written cells exactly 0;
  * comparator masks and support counts exact on every cell whose patch
    holds no value within 4 ULP of ``v_tw`` (an exp an ULP apart can flip
    a comparison there); fewer than 0.1% of cells may be excluded;
  * scatter results, counts and masks of equal inputs bitwise.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edram as jedram
from repro.core import representations as jrep
from repro.core import time_surface as jts
from repro.kernels import ops as jops
from repro_torch.core import edram as tedram
from repro_torch.core import representations as trep
from repro_torch.core import time_surface as tts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

jax.config.update("jax_platforms", "cpu")

T_NOW = 0.1
SHAPE = (3, 2, 40, 72)   # slots, polarities, H, W


def _sae(seed, shape=SHAPE, never=0.3):
    rng = np.random.default_rng(seed)
    sae = rng.uniform(0.0, T_NOW, shape).astype(np.float32)
    sae[rng.random(shape) < never] = -np.inf
    return sae


def _params(mode):
    if mode == "edram":
        return jedram.decay_params_for_cmem(), tedram.decay_params_for_cmem()
    return jrep.edram_ideal_params(0.024), trep.edram_ideal_params(0.024)


def _ulp(a, b):
    return tref.ulp_distance(torch.from_numpy(np.array(a, np.float32)),
                             torch.from_numpy(np.array(b, np.float32))).numpy()


def _near_threshold(v, v_tw, radius=0):
    """Cells within 4 ULP of v_tw, dilated to every pixel whose
    (2r+1)^2 patch holds one."""
    near = _ulp(v, np.full_like(v, np.float32(v_tw))) <= 4
    if radius:
        near = tref.stcf_support_ref(torch.from_numpy(near), radius,
                                     include_self=True).numpy() > 0
    assert near.mean() < 1e-3, near.mean()
    return near


@pytest.mark.parametrize("mode", ["edram", "ideal"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ts_decay_uniform(mode, seed):
    sae = _sae(seed)
    jp, tp = _params(mode)
    want = np.asarray(jops.ts_decay(jnp.asarray(sae), T_NOW, jp,
                                    backend="ref"))
    got = tops.ts_decay(torch.from_numpy(sae), T_NOW, tp).numpy()
    assert got.dtype == np.float32 and got.shape == sae.shape
    assert _ulp(got, want).max() <= 2
    assert np.all(got[np.isneginf(sae)] == 0.0)


def test_ts_decay_planes():
    rng = np.random.default_rng(7)
    sae = _sae(2)
    base = jedram.decay_params_for_cmem()
    eps = 1.0 + 0.05 * rng.standard_normal((2,) + SHAPE[-2:])
    planes = [np.full(SHAPE[-2:], np.float32(base.a1), np.float32),
              (np.float32(base.tau1) / eps[0]).astype(np.float32),
              np.full(SHAPE[-2:], np.float32(base.a2), np.float32),
              (np.float32(base.tau2) / eps[1]).astype(np.float32),
              np.full(SHAPE[-2:], np.float32(base.b), np.float32)]
    jp = jedram.DecayParams(*(jnp.asarray(x) for x in planes))
    tp = tedram.DecayParams(*(torch.from_numpy(x) for x in planes))
    want = np.asarray(jops.ts_decay(jnp.asarray(sae), T_NOW, jp,
                                    backend="ref"))
    got = tops.ts_decay(torch.from_numpy(sae), T_NOW, tp).numpy()
    assert _ulp(got, want).max() <= 2
    assert np.all(got[np.isneginf(sae)] == 0.0)


def test_ts_decay_interpret():
    """A tiny case against the Pallas kernel itself (interpret mode)."""
    sae = _sae(3, shape=(1, 1, 16, 128))
    jp, tp = _params("edram")
    want = np.asarray(jops.ts_decay(jnp.asarray(sae), T_NOW, jp,
                                    block=(8, 128), backend="interpret"))
    got = tops.ts_decay(torch.from_numpy(sae), T_NOW, tp).numpy()
    assert _ulp(got, want).max() <= 2


# (lead, plane, aligned): the smoke's pool, a ragged plane, a misaligned
# pointer, one plane, few planes of a tiny plane, more groups than grid.y
_LAUNCHES = [(128, 240 * 320, True), (3, 37 * 61, True), (128, 76800, False),
             (1, 240 * 320, True), (3, 1, True), (1 << 20, 4, True),
             (128, 5 * 1001, True), (5, 1024, True)]


@pytest.mark.parametrize("lead, plane, aligned", _LAUNCHES)
def test_ts_decay_planes_launch_shape(lead, plane, aligned):
    """The plane form's launch shape: float4 columns only for an aligned
    plane of a multiple of 4 cells, the plane covered by grid[0] blocks
    with the ragged tail in the last one, the leading planes by grid[1]
    groups of at most PLANE_GROUP (more only past the grid's y limit)."""
    from repro_torch.kernels import ts_decay as tdk

    vec4, group, (gx, gy) = tdk.planes_launch(lead, plane, aligned)
    assert vec4 == (aligned and plane % 4 == 0)
    per_block = tdk.THREADS * (4 if vec4 else 1)
    assert (gx - 1) * per_block < plane <= gx * per_block
    assert (gy - 1) * group < lead <= gy * group
    assert gy <= tdk.MAX_GRID_Y and group >= 1
    if lead <= tdk.MAX_GRID_Y:
        assert group <= tdk.PLANE_GROUP
    if group < tdk.PLANE_GROUP and lead > group:
        # fewer planes a block only to keep the card's SMs fed
        assert lead * gx // tdk.TARGET_BLOCKS < tdk.PLANE_GROUP


def test_ts_decay_planes_launch_on_the_pool():
    from repro_torch.kernels import ts_decay as tdk

    assert tdk.planes_launch(128, 76800, True) == (True, 8, (75, 16))
    assert tdk.planes_launch(128, 76800, False) == (False, 8, (300, 16))
    assert tdk.planes_launch(3, 2257, True) == (False, 1, (9, 3))
    assert tdk.planes_launch(1, 1, True) == (False, 1, (1, 1))


def _rn32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest float32, ties to even."""
    near = np.float32(float(x))
    if not np.isfinite(near):
        return near
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


def test_corrected_reciprocal_quotient_is_ieee_division():
    """decay.cuh's quotient of a fixed divisor, q = RN(x * rcp), r =
    fma(-q, tau, x), q' = fma(r, rcp, q) with rcp = RN(1/tau), emulated
    exactly with Fractions, against float32 division: the division
    gate's taus (``ts_decay.gate_taus``: both fits of the sweep's cmem
    grid, the ideal 5 and 24 ms surfaces, 1.0, the clamp, an all-ones
    significand) and 2^-10, and seeded dividends in the range the kernel
    takes this path for."""
    rng = np.random.default_rng(17)
    ages = np.concatenate([rng.uniform(0.0, 0.2, 150),
                           10.0 ** rng.uniform(-6, 3, 100)])
    bits = ((rng.integers(60, 190, 100) << 23)
            | rng.integers(0, 1 << 23, 100)).astype(np.uint32)
    xs = np.concatenate([-ages, bits.view(np.float32)]).astype(np.float32)
    in_range = lambda z: 2.0 ** -96 <= abs(float(z)) < 2.0 ** 126
    from repro_torch.kernels.ts_decay import gate_taus

    taus = gate_taus() + [2.0 ** -10]   # the 10 fF fit ~1 s, the check ~0.2 s
    checked = 0
    for tau in map(np.float32, taus):
        rcp = np.float32(1.0) / tau
        for x in xs:
            q = _rn32(Fraction(float(x)) * Fraction(float(rcp)))
            if not (in_range(x) and in_range(q)):
                continue   # the kernel takes __fdiv_rn there
            r = _rn32(Fraction(float(x)) - Fraction(float(q)) * Fraction(
                float(tau)))
            q1 = _rn32(Fraction(float(r)) * Fraction(float(rcp))
                       + Fraction(float(q)))
            assert q1.view(np.uint32) == (x / tau).view(np.uint32), (x, tau)
            checked += 1
    assert checked > 0.9 * len(xs) * len(taus)


@pytest.mark.parametrize("mode", ["edram", "ideal"])
def test_ts_decay_with_mask(mode):
    sae = _sae(4)
    jp, tp = _params(mode)
    v_tw = tedram.v_tw_for_window(0.024, tp) if mode == "edram" else \
        float(np.exp(-0.024 / 0.024))
    jv, jm = jops.ts_decay_with_mask(jnp.asarray(sae), T_NOW, jp, v_tw,
                                     backend="ref")
    tv, tm = tops.ts_decay_with_mask(torch.from_numpy(sae), T_NOW, tp, v_tw)
    assert _ulp(tv.numpy(), np.asarray(jv)).max() <= 2
    assert tm.dtype == torch.bool
    far = ~_near_threshold(np.asarray(jv), v_tw)
    np.testing.assert_array_equal(tm.numpy()[far], np.asarray(jm)[far])


@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("include_self", [False, True])
def test_stcf_support_fused(radius, include_self):
    sae = _sae(5 + radius)
    jp, tp = _params("edram")
    v_tw = tedram.v_tw_for_window(0.024, tp)
    want = np.asarray(jops.stcf_support_fused(
        jnp.asarray(sae), jp, v_tw, T_NOW, radius=radius,
        include_self=include_self, backend="ref"))
    got = tops.stcf_support_fused(torch.from_numpy(sae), tp, v_tw, T_NOW,
                                  radius=radius, include_self=include_self)
    assert got.dtype == torch.int32
    v = np.asarray(jops.ts_decay(jnp.asarray(sae), T_NOW, jp, backend="ref"))
    far = ~_near_threshold(v, v_tw, radius)
    np.testing.assert_array_equal(got.numpy()[far], want[far])
    # inside the port: fused == ts_decay_with_mask -> stcf_support, bitwise
    _, m = tops.ts_decay_with_mask(torch.from_numpy(sae), T_NOW, tp, v_tw)
    assert torch.equal(got, tops.stcf_support(m, radius, include_self))


def test_stcf_support_fused_interpret():
    sae = _sae(9, shape=(1, 1, 16, 40))
    jp, tp = _params("edram")
    v_tw = tedram.v_tw_for_window(0.024, tp)
    want = np.asarray(jops.stcf_support_fused(
        jnp.asarray(sae), jp, v_tw, T_NOW, radius=3, block_h=8,
        backend="interpret"))
    got = tops.stcf_support_fused(torch.from_numpy(sae), tp, v_tw, T_NOW,
                                  radius=3).numpy()
    v = np.asarray(jops.ts_decay(jnp.asarray(sae), T_NOW, jp, backend="ref"))
    far = ~_near_threshold(v, v_tw, 3)
    np.testing.assert_array_equal(got[far], want[far])


@pytest.mark.parametrize("radius", [1, 3, 9])
@pytest.mark.parametrize("include_self", [False, True])
def test_stcf_support_mask(radius, include_self):
    mask = np.random.default_rng(radius).random(SHAPE) < 0.2
    want = np.asarray(jops.stcf_support(jnp.asarray(mask), radius=radius,
                                        include_self=include_self,
                                        backend="ref"))
    got = tops.stcf_support(torch.from_numpy(mask), radius, include_self)
    np.testing.assert_array_equal(got.numpy(), want)


def _events(seed, lead, n, h, w, p_hi=3):
    """Events with duplicates, out-of-range x/y/p, negative stamps and an
    all-invalid row."""
    rng = np.random.default_rng(seed)
    shape = lead + (n,)
    ev = dict(
        x=rng.integers(-3, w + 3, shape).astype(np.int32),
        y=rng.integers(-3, h + 3, shape).astype(np.int32),
        t=rng.uniform(-0.05, T_NOW, shape).astype(np.float32),
        p=rng.integers(-1, p_hi, shape).astype(np.int32),
        valid=rng.random(shape) < 0.8,
    )
    half = n // 2   # the second half repeats the first half's pixels
    ev["x"][..., half:2 * half] = ev["x"][..., :half]
    ev["y"][..., half:2 * half] = ev["y"][..., :half]
    if lead:
        ev["valid"][(0,) * len(lead)] = False
    return ev


def _both(ev):
    return (jts.EventBatch(**{k: jnp.asarray(v) for k, v in ev.items()}),
            tts.EventBatch(**{k: torch.from_numpy(v) for k, v in ev.items()}))


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("polarities", [1, 2])
def test_chunk_scatter_and_ts_fused(polarities):
    shape = (3, polarities, 40, 72)
    sae = _sae(11, shape=shape)
    je, te = _both(_events(12, (3,), 96, 40, 72))
    want = jops.chunk_scatter(jnp.asarray(sae), je, backend="ref")
    got = tops.chunk_scatter(torch.from_numpy(sae), te)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got[0]), _bits(sae[0]))   # all-invalid row
    jp, tp = _params("edram")
    v_tw = tedram.v_tw_for_window(0.024, tp)
    new, v, m = tops.ts_fused(torch.from_numpy(sae), te, T_NOW, tp, v_tw)
    assert torch.equal(new.view(torch.int32), got.view(torch.int32))
    v2, m2 = tops.ts_decay_with_mask(got, T_NOW, tp, v_tw)
    assert torch.equal(v.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(m, m2)


def test_chunk_scatter_interpret():
    sae = _sae(13, shape=(1, 2, 8, 128))
    je, te = _both(_events(14, (1,), 16, 8, 128, p_hi=2))
    je = je._replace(valid=jnp.ones_like(je.valid))
    te = te._replace(valid=torch.ones_like(te.valid))
    want = jops.chunk_scatter(jnp.asarray(sae), je, block=(8, 128),
                              backend="interpret")
    got = tops.chunk_scatter(torch.from_numpy(sae), te)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_chunk_scatter_pool_bookkeeping():
    """The engine form: slots chosen per row (duplicates included), with
    the dirty marks, counter plane, t_last and n_events the reference
    engine's scatter body computes."""
    from repro.serve import ts_engine as jeng

    s, p, h, w, block = 3, 2, 40, 72, (8, 128)
    sae = _sae(15, shape=(s, p, h, w))
    ev = _events(16, (4,), 96, h, w)
    sids = np.array([2, 0, 2, 1], np.int32)
    th, tw, tpl = tops.tile_geometry(h, w, block)
    jstate = jeng.EngineState(
        surfaces=jts.SurfaceState(jnp.asarray(sae), jnp.zeros(s, jnp.float32),
                                  jnp.zeros(s, jnp.int32)),
        generation=jnp.zeros(s, jnp.int32),
        cache=jeng.ReadoutCache(jnp.zeros((s, p * tpl) + block, jnp.float32),
                                jnp.zeros((s, p * tpl), bool)),
        counts=jnp.zeros((s, h, w), jnp.int32),
    )
    je, te = _both(ev)
    jout = jeng.ingest_step(jstate, jnp.asarray(sids), je, polarities=p)
    t_sae = torch.from_numpy(sae.copy())
    dirty = torch.zeros((s, p * tpl), dtype=torch.bool)
    counts = torch.zeros((s, h, w), dtype=torch.int32)
    t_last = torch.zeros(s)
    n_events = torch.zeros(s, dtype=torch.int32)
    tops.chunk_scatter_(t_sae, torch.from_numpy(sids), te, dirty, block,
                        counts, t_last, n_events)
    np.testing.assert_array_equal(_bits(t_sae), _bits(jout.surfaces.sae))
    np.testing.assert_array_equal(_bits(t_last), _bits(jout.surfaces.t_last))
    np.testing.assert_array_equal(n_events.numpy(),
                                  np.asarray(jout.surfaces.n_events))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jout.counts))
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(jout.cache.dirty))


def test_dirty_tiles_incremental_equals_dense():
    """ts_fused_dirty: patching the tiles a scatter marked on a dense fill
    equals a dense read of the new SAE, bitwise."""
    block = (8, 32)
    s, p, h, w = 2, 2, 20, 72
    _, tp = _params("edram")
    _, _, tpl = tops.tile_geometry(h, w, block)
    sae = torch.from_numpy(_sae(17, shape=(s, p, h, w)))
    _, cache, dirty = tops.ts_fused_dirty(
        sae, torch.zeros((s * p * tpl,) + block),
        torch.zeros(s * p * tpl, dtype=torch.bool), T_NOW, tp,
        max_dirty=8, block=block, force_dense=True)
    rng = np.random.default_rng(18)
    _, te = _both(dict(
        x=rng.integers(0, w, (s, 3)).astype(np.int32),
        y=rng.integers(0, h, (s, 3)).astype(np.int32),
        t=rng.uniform(0.0, T_NOW, (s, 3)).astype(np.float32),
        p=rng.integers(0, p, (s, 3)).astype(np.int32),
        valid=np.ones((s, 3), bool)))
    tops.chunk_scatter_(sae, torch.arange(s, dtype=torch.int32), te,
                        dirty=dirty.view(s, p * tpl), block=block)
    assert 0 < int(dirty.sum()) <= 8
    surf, _, cleared = tops.ts_fused_dirty(sae, cache, dirty, T_NOW, tp,
                                           max_dirty=8, block=block)
    dense = tops.ts_decay(sae, T_NOW, tp)
    assert torch.equal(surf.view(torch.int32), dense.view(torch.int32))
    assert not cleared.any()


def test_reads_off_counts_and_sae():
    counts = np.random.default_rng(19).integers(0, 40, (3, 40, 72)).astype(
        np.int32)
    sae = _sae(20)
    np.testing.assert_array_equal(
        tops.event_count_read(torch.from_numpy(counts), 4).numpy(),
        np.asarray(jops.event_count_read(jnp.asarray(counts), n_bits=4)))
    np.testing.assert_array_equal(
        tops.ebbi_read(torch.from_numpy(sae)).numpy(),
        np.asarray(jops.ebbi_read(jnp.asarray(sae))))


def test_offline_sae_update_matches_reference():
    """The offline SAE builder (plain tensor ops) vs the reference's
    ``sae_update``, bitwise, polarity-merged and not, out-of-range
    indices included."""
    je, te = _both(_events(21, (), 200, 40, 72, p_hi=2))
    for pp, merge in ((2, False), (2, True), (1, False)):
        want = jts.sae_update(jts.empty_sae(40, 72, pp), je,
                              merge_polarity=merge)
        got = tts.sae_update(tts.empty_sae(40, 72, pp, device="cpu"), te,
                             merge_polarity=merge)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_v_tw_and_params_match_reference():
    """DecayParams bitwise; v_tw_for_window in float32 within 1 ULP of the
    reference's (0 measured on this CPU build)."""
    for cmem in (20e-15, 10e-15):
        jp = jedram.decay_params_for_cmem(cmem)
        tp = tedram.decay_params_for_cmem(cmem)
        for a, b in zip(jp, tp):
            assert np.float32(a).view(np.int32) == np.float32(b).view(np.int32)
        for tw in (0.005, 0.024):
            want = np.float32(jedram.v_tw_for_window(tw, jp))
            got = np.float32(tedram.v_tw_for_window(tw, tp))
            assert _ulp(got, want).max() <= 1


def test_non_cpu_non_cuda_tensor_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.ts_decay(torch.empty((2, 8), device="meta"), 0.0,
                      tedram.decay_params_for_cmem())


def test_host_event_modules_match_reference():
    """pipeline.to_event_batch / window_chunks, edram.v_mem / ideal_exp
    and rebase_times against the reference on one seeded stream."""
    from repro.events import datasets as jdatasets
    from repro.events import pipeline as jpipe
    from repro_torch.events import pipeline as tpipe

    s = jdatasets.dnd21_like("hotel_bar", 24, 32, 0.03, seed=3)
    for want, got in ((jpipe.to_event_batch(s, 4096),
                       tpipe.to_event_batch(s, 4096, device="cpu")),
                      (jpipe.window_chunks(s, 0.005, 64),
                       tpipe.window_chunks(s, 0.005, 64, device="cpu"))):
        for a, b in zip(want, got):
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    dt = np.concatenate([np.linspace(0.0, 0.08, 257, dtype=np.float32),
                         [np.inf]]).astype(np.float32)
    jp, tp = _params("edram")
    assert _ulp(tedram.v_mem(dt, tp).numpy(),
                jedram.v_mem(jnp.asarray(dt), jp)).max() <= 2
    assert _ulp(tedram.ideal_exp(dt, 0.024).numpy(),
                jedram.ideal_exp(jnp.asarray(dt), 0.024)).max() <= 2
    t = np.array([3600.0, 3600.000001, 3600.5])
    np.testing.assert_array_equal(tts.rebase_times(t, 3600.0),
                                  jts.rebase_times(t, 3600.0))
