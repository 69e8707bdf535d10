"""The port's slot pool over several shards, on the CPU.

``TimeSurfaceEngine(cfg, mesh=make_host_mesh(n, device="cpu"))`` splits
the pool into ``n`` CPU shards, each with tensors of its own: the code a
multi-card host runs.  Three kinds of test:

  * the reference's one-device-mesh cases (``tests/test_serve_sharded.py``,
    ``tests/test_stream_runtime.py``'s mesh cases, ``tests/test_mesh.py``'s
    pool rules) on a one-shard port mesh beside the JAX engine on
    ``make_host_mesh(1)`` (``backend="ref"``), and on two and three shards
    beside the JAX engine unsharded;
  * the port against itself: sharded == unsharded bitwise, padded pools,
    cross-shard migration, grow / shrink at padded sizes, ``push_labeled``,
    the ring, analog and head-bearing specs, the stream and its oracle;
  * one subprocess run (marked ``slow`` like the reference's sweeps) of
    the reference on a 2-device host mesh and the port on 2 CPU shards
    under the multi-shard EDF scheduler: equal action logs.

Bands across packages: integer and bool state bitwise, decay reads within
the reference's 2 ULP (``tests/test_kernel_equivalence.py::_ulp_close``),
comparator products equal away from the threshold; inside the port,
everything bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshd
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.events import replay as jrp
from repro.launch.mesh import make_host_mesh as jmesh
from repro.serve import spec as jspec
from repro.serve import stream as jstream
from repro.serve import ts_engine as jeng
from repro_torch.distributed import sharding as tshd
from repro_torch.events import replay as trp
from repro_torch.events import synthetic as tsyn
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.serve import fidelity as tfm
from repro_torch.serve import spec as tspec
from repro_torch.serve import stream as tstream
from repro_torch.serve import ts_engine as teng

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, CAP = 48, 64, 512
SHARDS = [1, 2, 3]


def _composed(m):
    return m.ReadoutSpec(surface=m.surface(), stcf=m.stcf(),
                         count=m.count(4), ebbi=m.ebbi())


def _frame(m):
    return m.ReadoutSpec(surface=m.surface(), mask=m.mask(), stcf=m.stcf(),
                         count=m.count(4), ebbi=m.ebbi())


def _cfgs(n_slots, mode="edram", **kw):
    base = dict(h=H, w=W, n_slots=n_slots, chunk_capacity=CAP, mode=mode,
                **kw)
    return (jeng.TSEngineConfig(**base, backend="ref",
                                specs=(_frame(jspec),)),
            teng.TSEngineConfig(**base, specs=(_frame(tspec),)))


def _mesh(n):
    return make_host_mesh(n, device="cpu")


def _engines(n, n_slots, mode="edram", **kw):
    """(reference, port sharded over ``n`` CPU shards, port unsharded):
    the reference on a 1-device mesh when ``n == 1``, unsharded else."""
    jcfg, tcfg = _cfgs(n_slots, mode, **kw)
    je = jeng.TimeSurfaceEngine(jcfg, mesh=jmesh(1) if n == 1 else None)
    return (je, teng.TimeSurfaceEngine(tcfg, mesh=_mesh(n)),
            teng.TimeSurfaceEngine(tcfg, device="cpu"))


def _words(i, t_lo=0.0, t_hi=0.06):
    s = jdatasets.dnd21_like("driving" if i % 2 else "hotel_bar",
                             h=H, w=W, duration=0.06, seed=i)
    return jaer.pack(s.window(t_lo, t_hi))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same(a, b):
    """Bitwise equality of two port tensors."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(_bits(a.numpy()), _bits(b.numpy())))


def _ulp(a, b):
    return tref.ulp_distance(torch.as_tensor(np.array(a, np.float32)),
                             torch.as_tensor(np.array(b, np.float32)))


def _assert_products(tout, jout, n, v_tw, radius=3, pad_zero=True):
    """Port products (``n_slots_padded`` rows) vs the reference's on the
    first ``n`` rows: decay reads within 2 ULP, comparator products equal
    away from V_tw, the rest bitwise; the port's dead tail all zero."""
    v = np.asarray(jout["surface"])[:n]
    near = _ulp(v, np.full_like(v, np.float32(v_tw))).numpy() <= 4
    near_patch = tref.stcf_support_ref(
        torch.from_numpy(near), radius, include_self=True).numpy() > 0
    for name, got in tout.items():
        want = np.asarray(jout[name])[:n]
        g = got.numpy()
        assert g.dtype == want.dtype, name
        if pad_zero and g.shape[0] > n:
            assert not np.abs(g[n:].astype(np.float64)).max(), name
        g = g[:n]
        assert g.shape == want.shape, name
        if name == "surface":
            assert int(_ulp(g, want).max()) <= 2
        elif name == "mask":
            np.testing.assert_array_equal(g[~near], want[~near])
        elif name == "stcf":
            np.testing.assert_array_equal(g[~near_patch], want[~near_patch])
        else:
            np.testing.assert_array_equal(_bits(g), _bits(want), err_msg=name)


def _assert_port_equal(a, b):
    """Two port product dicts bitwise equal."""
    assert list(a) == list(b)
    for name in a:
        assert _same(a[name], b[name]), name


def _assert_state_equal(sharded, plain):
    """Every leaf of the sharded pool (gathered) bitwise the unsharded
    pool's on its first rows; the dead tail never-written."""
    n = plain.n_slots_padded
    s, p = sharded.gather_state(), plain.state
    for a, b in zip(teng._leaves(s), teng._leaves(p)):
        if b is None:
            assert a is None
            continue
        assert _same(a[:n], b)


def _assert_int_state_matches_reference(te, je, n):
    """Integer and bool state bitwise the reference's on the first rows."""
    ts_, js = te.gather_state(), je.state
    for a, b in ((ts_.surfaces.sae, js.surfaces.sae),
                 (ts_.surfaces.t_last, js.surfaces.t_last),
                 (ts_.surfaces.n_events, js.surfaces.n_events),
                 (ts_.generation, js.generation),
                 (ts_.cache.dirty, js.cache.dirty),
                 (ts_.counts, js.counts)):
        np.testing.assert_array_equal(_bits(a.numpy()[:n]),
                                      _bits(np.asarray(b)[:n]))


# ---------------------------------------------------------------------------
# pool rules and meshes (tests/test_mesh.py:112-134)
# ---------------------------------------------------------------------------

class _FakeMesh:
    shape = {"pod": 2, "data": 4, "model": 16}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_slot_pool_rules_match_reference(n):
    mesh = _mesh(n)
    assert tshd.data_axes(mesh) == ("data",)
    assert tshd.slot_shard_count(mesh) == jshd.slot_shard_count(mesh) == n
    for cap in range(1, 13):
        assert tshd.pad_pool(cap, mesh) == jshd.pad_pool(cap, mesh)
        assert tshd.pad_pool(cap, mesh) % n == 0
        for slot in range(cap):
            assert tshd.shard_of(slot, 3) == jshd.shard_of(slot, 3)
    assert tshd.slot_pool_devices(mesh) == [torch.device("cpu")] * n
    if n == 1:   # the reference's own one-device mesh, same rules
        jm = jmesh(1)
        assert tshd.slot_shard_count(jm) == 1 and tshd.pad_pool(5, jm) == 5
    assert tshd.slot_shard_count(_FakeMesh()) == 8
    assert [tshd.pad_pool(c, _FakeMesh()) for c in (6, 8, 9)] == [8, 8, 16]


def test_make_host_mesh_cycles_and_records_placement():
    cpu = torch.device("cpu")
    m = make_host_mesh(3, device="cpu")
    assert m.devices == (cpu,) * 3 and m.shape == {"data": 3}
    assert m.placement() == "shard 0 -> cpu, shard 1 -> cpu, shard 2 -> cpu"
    assert make_host_mesh(devices=["cpu", "cpu"]).devices == (cpu, cpu)
    assert make_host_mesh(5, devices=["cpu"]).size == 5
    with pytest.raises(ValueError, match="at least one shard"):
        make_host_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="shard 0"):
        teng.TimeSurfaceEngine(_cfgs(2)[1], device="cuda:0", mesh=m)
    class _Short:   # two shards, one device listed
        shape, devices = {"data": 2}, (cpu,)

    with pytest.raises(ValueError, match="lists 1 devices for 2 shards"):
        tshd.slot_pool_devices(_Short())
    assert isinstance(m, HostMesh)


def test_shard_state_on_another_device_raises():
    eng = teng.TimeSurfaceEngine(_cfgs(4)[1], mesh=_mesh(2))
    with pytest.raises(ValueError, match="shard 1 lives on cpu"):
        eng._install(1, teng.init_state(eng.cfg, "meta", n_slots=2))


@pytest.mark.parametrize("n", SHARDS)
def test_stats_mesh_and_padding(n):
    eng = teng.TimeSurfaceEngine(_cfgs(5)[1], mesh=_mesh(n))
    padded = -(-5 // n) * n
    st = eng.stats()
    assert eng.n_slots_padded == st["n_slots_padded"] == padded
    assert st["mesh"] == {"axes": ["data"], "n_shards": n,
                          "n_slots_padded": padded,
                          "slots_per_shard": padded // n,
                          "devices": ["cpu"] * n}
    assert st["max_dirty_tiles"] == max(16, padded // n * 3 // 4)
    assert "mesh" not in teng.TimeSurfaceEngine(
        _cfgs(5)[1], device="cpu").stats()
    cams = [eng.attach() for _ in range(5)]
    assert [c.slot for c in cams] == list(range(5))
    with pytest.raises(RuntimeError, match="no free sensor slots"):
        eng.attach()   # the dead tail is never handed out
    eng.push([(c, _words(c.slot)) for c in cams[::2]])
    st, g = eng.stats(), eng.gather_state()
    assert st["generation"] == g.generation[:5].tolist()
    assert st["n_events"] == g.surfaces.n_events[:5].tolist()
    assert st["t_last"] == g.surfaces.t_last[:5].tolist()
    assert st["dirty_tiles"] == int(g.cache.dirty.sum()) > 0
    assert [x > 0 for x in st["n_events"]] == [True, False] * 2 + [True]


@pytest.mark.parametrize("n", SHARDS)
def test_gather_state_is_a_copy_and_state_one_shard_only(n):
    """``gather_state`` copies the pool at every shard count; ``state``
    is the pool's own tensors and exists for one shard only."""
    eng = teng.TimeSurfaceEngine(_cfgs(4)[1], mesh=_mesh(n))
    cam = eng.attach()
    cam.push(_words(0))
    g = eng.gather_state()
    assert g.surfaces.sae.shape[0] == eng.n_slots_padded
    g.surfaces.n_events.zero_()
    assert eng.stats()["n_events"][cam.slot] > 0
    if n == 1:
        assert eng.state.surfaces.sae is eng._states[0].surfaces.sae
    else:
        with pytest.raises(RuntimeError, match="gather_state"):
            eng.state


# ---------------------------------------------------------------------------
# the reference's one-device-mesh cases (tests/test_serve_sharded.py:47-188),
# at one, two and three port shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
def test_sharded_readout_lifecycle(n):
    """Reads, release and reuse through the per-shard reset: bitwise the
    unsharded port, within the bands of the reference."""
    je, te, tp = _engines(n, 3)
    words = [_words(i) for i in range(3)]
    for e in (je, te, tp):
        cams = [e.attach() for _ in range(3)]
        e.push(list(zip([c.slot for c in cams], words)))
    frame_t, frame_j = _frame(tspec), _frame(jspec)
    got = te.read(frame_t, 0.08)
    _assert_port_equal({k: v[:3] for k, v in got.items()},
                       tp.read(frame_t, 0.08))
    _assert_products(got, je.read(frame_j, 0.08), 3, te.cfg.v_tw())
    _assert_int_state_matches_reference(te, je, 3)
    for e in (je, te, tp):
        e._sessions[1].detach()
    assert float(te.read(tspec.SURFACE_SPEC, 0.1)["surface"][1].max()) == 0
    assert te.attach().slot == 1
    tp.attach(), je.attach()
    st = te.stats()
    assert st["generation"][1] == 2 and st["n_events"][1] == 0
    assert st["generation"] == je.stats()["generation"]
    _assert_state_equal(te, tp)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("mode", ["ideal", "edram"])
def test_sharded_support_labels(n, mode):
    """``push_labeled`` on a sharded pool: the unsharded port's supports
    and pool bitwise; with ideal decay (where the comparison has no band)
    the reference's supports exactly, and its integer state always."""
    je, te, tp = _engines(n, 5, mode)
    words = [_words(i, 0.0, 0.03) for i in range(5)]
    for e in (je, te, tp):
        cams = [e.attach() for _ in range(5)]
        for c, wd in zip(cams, words):
            c.push(wd[: len(wd) // 3])
    for k in (4, 1):
        rest = words[k][len(words[k]) // 3:]
        s_sup, s_sig = te._sessions[k].push_labeled(rest)
        p_sup, p_sig = tp._sessions[k].push_labeled(rest)
        assert _same(s_sup, p_sup) and _same(s_sig, p_sig)
        j_sup, j_sig = je._sessions[k].push_labeled(rest)
        if mode == "ideal":
            np.testing.assert_array_equal(s_sup.numpy(), np.asarray(j_sup))
            np.testing.assert_array_equal(s_sig.numpy(), np.asarray(j_sig))
    _assert_state_equal(te, tp)
    _assert_int_state_matches_reference(te, je, 5)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_fused_serve_step(n):
    """The fused dirty-tile path, each shard refreshing its own rows:
    dense fill, incremental steps, release + pure cached read, t-move;
    bitwise the unsharded port and a dense read, within the reference's
    bands."""
    je, te, tp = _engines(n, 3)
    words = [_words(i) for i in range(4)]
    spec_t, spec_j = tspec.SURFACE_SPEC, jspec.SURFACE_SPEC
    for e in (je, te, tp):
        for _ in range(3):
            e.attach()

    def step(items, t):
        got = te.serve_step(items, spec_t, t)
        _assert_port_equal({k: v[:3] for k, v in got.items()},
                           tp.serve_step(items, spec_t, t))
        _assert_port_equal(got, te.read(spec_t, t))
        _assert_products(got, je.serve_step(items, spec_j, t), 3,
                         te.cfg.v_tw())

    step([(0, words[0])], 0.08)
    for i in (1, 2):
        step([(i, words[i])], 0.08)
    for e in (je, te, tp):
        e._sessions[1].detach()
    step([], 0.08)
    for e in (je, te, tp):
        e.attach()
    step([(2, words[3])], 0.1)
    _assert_state_equal(te, tp)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_small_pool_refill_is_dense(n):
    """A pool whose tiles all fit under each shard's gather cap still
    refills densely when t_now moves: every step == ``read``."""
    cfg = _cfgs(n, block=(8, 128))[1]
    eng = teng.TimeSurfaceEngine(cfg, mesh=_mesh(n))
    assert eng.stats()["max_dirty_tiles"] >= cfg.tile_counts()[2]
    cam = eng.attach()
    words = _words(0)
    for t_read in (0.05, 0.08, 0.08, 0.1):
        surf = eng.serve_step([(cam, words)], tspec.SURFACE_SPEC, t_read)
        _assert_port_equal(surf, eng.read(tspec.SURFACE_SPEC, t_read))
    _assert_port_equal(eng.serve_step([], tspec.SURFACE_SPEC, 0.1),
                       eng.read(tspec.SURFACE_SPEC, 0.1))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_composed_spec(n):
    """A composed spec through ``read`` and ``serve_step`` (incremental
    at a held epoch, then a t-move), and a detach wiping the counter
    plane through the per-shard reset."""
    je, te, tp = _engines(n, 3)
    words = [_words(i) for i in range(4)]
    ct, cj = _composed(tspec), _composed(jspec)
    for e, c in ((je, cj), (te, ct), (tp, ct)):
        cams = [e.attach() for _ in range(3)]
        e.serve_step(list(zip([x.slot for x in cams], words)), c, 0.08)
    _assert_products(te.read(ct, 0.08), je.read(cj, 0.08), 3, te.cfg.v_tw())
    for t_now in (0.08, 0.1):
        got = te.serve_step([(0, words[3])], ct, t_now)
        _assert_port_equal({k: v[:3] for k, v in got.items()},
                           tp.serve_step([(0, words[3])], ct, t_now))
        _assert_products(got, je.serve_step([(0, words[3])], cj, t_now), 3,
                         te.cfg.v_tw())
    for e in (je, te, tp):
        e._sessions[1].detach()
    got = te.read(ct, 0.1)
    assert float(got["count"][1].max()) == 0.0
    _assert_products(got, je.read(cj, 0.1), 3, te.cfg.v_tw())
    # a session's read reads its own shard: the pool read's row, bitwise
    cam = te._sessions[2]
    _assert_port_equal(cam.read(ct, 0.1), {k: v[2] for k, v in got.items()})
    assert cam.generation == 1


# ---------------------------------------------------------------------------
# several shards: padded pools, migration, elastic sizes, the ring, analog
# and head-bearing specs, against the unsharded engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_cross_shard_migration_bitwise(n):
    """A migration between shards (a row copy to the destination shard,
    then a wipe) leaves the pool bitwise the unsharded move's, the
    reference's integer state included; the default destination is the
    least-loaded shard's lowest free slot."""
    je, te, tp = _engines(n, 5)
    words = [_words(i) for i in range(5)]
    frame_t = _frame(tspec)
    for e in (je, te, tp):
        cams = [e.attach() for _ in range(5)]
        e.serve_step(list(zip([c.slot for c in cams], words)),
                     tspec.SURFACE_SPEC if e is not je else
                     jspec.SURFACE_SPEC, 0.06)
        e._sessions[4].detach()
    sps = te.stats()["mesh"]["slots_per_shard"]
    src, dst = 0, 4
    assert src // sps != dst // sps
    for e in (je, te, tp):
        sess = e._sessions[src]
        assert e.migrate(src, dst) == dst and sess.slot == dst
    _assert_state_equal(te, tp)
    _assert_int_state_matches_reference(te, je, 5)
    _assert_port_equal({k: v[:5] for k, v in te.read(frame_t, 0.08).items()},
                       tp.read(frame_t, 0.08))
    # least-loaded shard's lowest free slot
    live = [s for s in range(te.capacity) if s not in te._free]
    want = min(te._free, key=lambda d: (
        sum(1 for s in live if s != 1 and s // sps == d // sps), d))
    assert te.migrate(1) == want
    _assert_port_equal(
        te.serve_step([(want, words[1])], tspec.SURFACE_SPEC, 0.08),
        te.read(tspec.SURFACE_SPEC, 0.08))


@pytest.mark.parametrize("n", [2, 3])
def test_grow_shrink_at_padded_sizes(n):
    """Elastic moves on a sharded pool: each capacity pads to a multiple
    of the shard count, rows move between shards as the blocks change
    and keep their bits; the shrink's compaction moves equal the
    unsharded engines'."""
    je, te, tp = _engines(n, 5, slot_bucket=3)
    words = [_words(i) for i in range(8)]
    for e in (je, te, tp):
        for _ in range(5):
            e.attach()
        e.push([(s, words[s]) for s in range(5)])
    for cap in (8, 11):
        assert je.grow() == te.grow() == tp.grow() == cap
        assert te.n_slots_padded == -(-cap // n) * n
        for e in (je, te, tp):
            while e.n_live < cap:
                e.attach()
        new = [(s, words[s % 8]) for s in range(cap - 3, cap)]
        for e in (je, te, tp):
            e.push(new)
        _assert_state_equal(te, tp)
        _assert_int_state_matches_reference(te, je, cap)
    for e in (je, te, tp):
        for s in (0, 2, 3, 5, 6, 7):
            e._sessions[s].detach()
    moves = te.shrink(5)
    assert moves == tp.shrink(5) == [tuple(m) for m in je.shrink(5)]
    assert te.n_slots_padded == -(-5 // n) * n
    _assert_state_equal(te, tp)
    _assert_int_state_matches_reference(te, je, 5)
    _assert_port_equal(
        {k: v[:5] for k, v in te.read(_frame(tspec), 0.08).items()},
        tp.read(_frame(tspec), 0.08))


@pytest.mark.parametrize("n", SHARDS)
def test_ring_push_per_shard_bitwise(n):
    """``push_staged`` stages each shard's rows into its own ring: the
    pool equals the host-staged ``push`` and the unsharded engine's."""
    cfg = _cfgs(5)[1]
    ring = teng.TimeSurfaceEngine(cfg, mesh=_mesh(n))
    host = teng.TimeSurfaceEngine(cfg, mesh=_mesh(n))
    plain = teng.TimeSurfaceEngine(cfg, device="cpu")
    rng = np.random.default_rng(3)
    parts = []
    for s in (4, 0, 2, 4, 1):
        k = int(rng.integers(1, CAP))
        parts.append((s, (rng.integers(0, W, k).astype(np.int32),
                          rng.integers(0, H, k).astype(np.int32),
                          np.sort(rng.random(k)).astype(np.float32) * 0.05,
                          rng.integers(0, 2, k).astype(np.int32))))
    for e in (ring, host, plain):
        for _ in range(5):
            e.attach()
    ring.push_staged(parts)
    plain.push_staged(parts)
    host.push([(s, tsyn.EventStream(
        x=x, y=y, t=t, p=p, is_signal=np.ones(len(x), bool), h=H, w=W))
        for s, (x, y, t, p) in parts])
    _assert_state_equal(ring, plain)
    for a, b in zip(teng._leaves(ring.gather_state()),
                    teng._leaves(host.gather_state())):
        assert (a is None and b is None) or _same(a, b)


@pytest.mark.parametrize("n", [2, 3])
def test_analog_and_head_specs_per_shard_bitwise(n):
    """Analog noise keys fold the generation value, never the slot, and
    heads run on weights copied to each shard: analog reads, ``Classify``
    logits and ``Denoise`` labels are bitwise the unsharded engine's,
    through ``read``, ``read_many`` and ``serve_step``."""
    head = tspec.ReadoutSpec(surface=tspec.surface(), stcf=tspec.stcf(),
                             logits=tspec.classify(n_classes=3, width=8),
                             labels=tspec.denoise())
    analog = tspec.ReadoutSpec(
        surface=tspec.surface(fidelity=tfm.analog_3d()),
        stcf=tspec.stcf(decay=tspec.surface(fidelity=tfm.analog_2d())),
        labels=tspec.denoise(input="stcf"))
    cfg = dataclasses.replace(_cfgs(5)[1], specs=(_frame(tspec),))
    te = teng.TimeSurfaceEngine(cfg, mesh=_mesh(n))
    tp = teng.TimeSurfaceEngine(cfg, device="cpu")
    words = [_words(i) for i in range(5)]
    for e in (te, tp):
        for _ in range(5):
            e.attach()
        e._sessions[3].detach()
        e.attach()                    # slot 3 at generation 2
        e.push([(s, words[s]) for s in range(5)])
    for sp in (head, analog):
        _assert_port_equal({k: v[:5] for k, v in
                            te.read(sp, 0.06, noise_step=4).items()},
                           tp.read(sp, 0.06, noise_step=4))
    got = te.read_many([head, analog, tspec.SURFACE_SPEC], 0.06, 2)
    want = tp.read_many([head, analog, tspec.SURFACE_SPEC], 0.06, 2)
    for sp in want:
        _assert_port_equal({k: v[:5] for k, v in got[sp].items()}, want[sp])
    _assert_port_equal(
        {k: v[:5] for k, v in
         te.serve_step([(1, words[0])], head, 0.07).items()},
        tp.serve_step([(1, words[0])], head, 0.07))


@pytest.mark.parametrize("n", [2, 3])
def test_load_state_onto_shards(n):
    """A whole pool state (``n_slots_padded`` rows, e.g. carried over from
    an unsharded engine) splits over the shards; reads match."""
    cfg = _cfgs(6)[1]
    tp = teng.TimeSurfaceEngine(cfg, device="cpu")
    for s in range(6):
        tp.attach()
        tp.push([(s, _words(s))])
    te = teng.TimeSurfaceEngine(cfg, mesh=_mesh(n))
    te.load_state(tp.state)
    _assert_state_equal(te, tp)
    _assert_port_equal(te.read(_frame(tspec), 0.08),
                       tp.read(_frame(tspec), 0.08))
    with pytest.raises(ValueError, match="sae"):
        te.load_state(teng.init_state(cfg, "cpu", n_slots=7))


# ---------------------------------------------------------------------------
# the stream over a mesh (tests/test_stream_runtime.py:371-435, :874-898)
# ---------------------------------------------------------------------------

SH, SW = 24, 32


def _log_view(log):
    """A package-neutral view of an action log: QoS classes by tier, step
    records by their schedule, flags and chunk contents."""
    out = []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            out.append((kind, e[0], e[1].tier))
        elif kind == "shrink":
            out.append((kind, e[0], [tuple(m) for m in e[1]]))
        elif kind == "step":
            out.append((kind, e.t_read, e.n_events, e.n_chunks, e.order,
                        e.deferred, e.overload, e.noise_step, e.barrier,
                        [(slot, [np.asarray(a).tolist() for a in part])
                         for slot, part in e.chunks]))
        else:
            out.append((kind, tuple(e) if isinstance(e, tuple) else e))
    return out


def _stream_cfg(m, **kw):
    base = dict(h=SH, w=SW, n_slots=4, chunk_capacity=64, block=(8, 16))
    if m is jeng:
        base["backend"] = "ref"
    return m.TSEngineConfig(**{**base, **kw})


@pytest.mark.parametrize("n", SHARDS)
def test_stream_over_shards_matches_unsharded(n):
    """The runtime over a sharded engine: the same digests as unsharded
    where the padded pool equals it, its own oracle on a sharded factory
    always, and the reference's counters on a 1-device mesh."""
    cfg = _stream_cfg(teng)
    scfg = tstream.StreamConfig(policy="drop_oldest", queue_capacity=256,
                                deadline_s=0.01)

    def feeds(m):
        return m.mixed_scene_feeds(SH, SW, 0.05, 4, seed=12, churn=True)

    plain = trp.replay(teng.TimeSurfaceEngine(cfg, device="cpu"),
                       feeds(trp), scfg)
    mesh = _mesh(n)
    rep = trp.replay(teng.TimeSurfaceEngine(cfg, mesh=mesh), feeds(trp), scfg)
    if -(-4 // n) * n == 4:
        assert rep.digests == plain.digests
    assert (rep.ingested, rep.dropped, rep.discarded) == (
        plain.ingested, plain.dropped, plain.discarded)
    assert trp.check_oracle(
        rep, lambda: teng.TimeSurfaceEngine(cfg, mesh=mesh)) == rep.n_steps
    jcfg = _stream_cfg(jeng)
    jrep = jrp.replay(
        jeng.TimeSurfaceEngine(jcfg, mesh=jmesh(1) if n == 1 else None),
        feeds(jrp), jstream.StreamConfig(policy="drop_oldest",
                                         queue_capacity=256, deadline_s=0.01))
    assert (rep.ingested, rep.dropped, rep.discarded, rep.n_steps) == (
        jrep.ingested, jrep.dropped, jrep.discarded, jrep.n_steps)
    assert _log_view(rep.log) == _log_view(jrep.log)


@pytest.mark.parametrize("n", SHARDS)
def test_stream_classify_tier_and_ring_over_shards(n):
    """A head-bearing gesture tier and the ring, over shards: digests
    equal the unsharded runtime's (ring on and off), and replay bitwise
    through the sharded oracle."""
    head_spec = tspec.ReadoutSpec(
        surface=tspec.surface(),
        logits=tspec.classify(n_classes=4, width=8))
    cfg = _stream_cfg(teng)

    def feeds():
        fs = trp.mixed_scene_feeds(SH, SW, 0.04, 4, seed=21, tiered=True)
        for f in fs:
            if f.qos.tier == "gesture":
                f.qos = dataclasses.replace(f.qos, spec=head_spec)
        return fs

    def run(mesh, ring):
        scfg = tstream.StreamConfig(policy="drop_oldest", queue_capacity=256,
                                    deadline_s=0.01, device_ring=ring)
        eng = (teng.TimeSurfaceEngine(cfg, device="cpu") if mesh is None
               else teng.TimeSurfaceEngine(cfg, mesh=mesh))
        return trp.replay(eng, feeds(), scfg)

    plain = run(None, True)
    mesh = _mesh(n)
    ring, host = run(mesh, True), run(mesh, False)
    assert ring.digests == host.digests
    if -(-4 // n) * n == 4:
        assert ring.digests == plain.digests
    trp.check_oracle(ring, lambda: teng.TimeSurfaceEngine(cfg, mesh=mesh))


def cross_shard_moves(log, n_slots, n_shards):
    """(source shard, destination shard) of every logged ``migrate``,
    following the padded pool through the logged grows and shrinks."""
    capacity, out = n_slots, []
    for kind, e in log:
        if kind == "grow":
            capacity = e
        elif kind == "shrink":
            capacity = e[0]
        elif kind == "migrate":
            sps = -(-capacity // n_shards)
            out.append((e[0] // sps, e[1] // sps))
    return out


def _fleet_scfg(m, **kw):
    return m.StreamConfig(policy="drop_oldest", deadline_s=0.005,
                          elastic=True, shrink_watermark=0.9,
                          step_chunk_budget=6, pipeline=True, **kw)


@pytest.mark.parametrize("n", [2, 3])
def test_fleet_churn_over_shards(n):
    """Fleet churn (elastic grows, a shrink with compaction, engine-picked
    migrations) on a sharded pool with per-shard budgets and barriers:
    the oracle on a sharded factory replays it bitwise, barriers fall
    every 4th deadline, tiers conserve their events, and the migrations
    land where the least-loaded rule puts them."""
    cfg = _stream_cfg(teng, n_slots=3, slot_bucket=3, chunk_capacity=1024)
    mesh = _mesh(n)
    mk = lambda: teng.TimeSurfaceEngine(cfg, mesh=mesh)  # noqa: E731
    rep = trp.replay(mk(), trp.fleet_scene_feeds(SH, SW, 0.06, 9, seed=3,
                                                 noise_hz=20.0),
                     _fleet_scfg(tstream, shard_budget=2,
                                 shard_barrier_every=4),
                     arrival_substeps=2)
    assert trp.check_oracle(rep, mk) == rep.n_steps
    steps = [e for k, e in rep.log if k == "step"]
    assert [i for i, e in enumerate(steps) if e.barrier] == [
        i for i in range(len(steps)) if (i + 1) % 4 == 0]
    kinds = [k for k, _ in rep.log]
    assert kinds.count("grow") >= 2 and kinds.count("shrink") >= 1
    assert kinds.count("migrate") == 3
    assert any(a != b for a, b in cross_shard_moves(rep.log, 3, n))
    for tier, row in rep.tiers.items():
        assert row["offered"] == (row["ingested"] + row["dropped"]
                                  + row["refused"] + row["discarded"]
                                  + row["deferred"]), tier


# ---------------------------------------------------------------------------
# the multi-shard EDF scheduler beside the reference's 2-device mesh
# ---------------------------------------------------------------------------

_EDF_BOTH = """
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
import json
import numpy as np
from repro.events import replay as jrp
from repro.launch.mesh import make_host_mesh as jmesh
from repro.serve import stream as jstream
from repro.serve import ts_engine as jeng
from repro_torch.events import replay as trp
from repro_torch.events import synthetic as tsyn
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import stream as tstream
from repro_torch.serve import ts_engine as teng

H, W = 24, 32
kw = dict(h=H, w=W, n_slots=3, slot_bucket=3, chunk_capacity=1 << 10,
          mode='edram', block=(8, 16))

def scfg(m):
    return m.StreamConfig(policy='drop_oldest', deadline_s=0.005,
                          elastic=True, shrink_watermark=0.9,
                          step_chunk_budget=6, pipeline=True,
                          shard_budget=2, shard_barrier_every=4)

def view(log):
    out = []
    for kind, e in log:
        if kind in ('attach', 'set_tier'):
            out.append([kind, e[0], e[1].tier])
        elif kind == 'shrink':
            out.append([kind, e[0], [list(m) for m in e[1]]])
        elif kind == 'step':
            out.append([kind, e.t_read, e.n_events, e.n_chunks,
                        [list(o) for o in e.order],
                        [list(d) for d in e.deferred], e.overload,
                        e.barrier])
        else:
            out.append([kind, e])
    return out

jm = jmesh(2)
j = jrp.replay(jeng.TimeSurfaceEngine(jeng.TSEngineConfig(**kw,
               backend='ref'), mesh=jm),
               jrp.fleet_scene_feeds(H, W, 0.06, 9, seed=3, noise_hz=20.0),
               scfg(jstream), arrival_substeps=2)
tm = make_host_mesh(2, device='cpu')
tcfg = teng.TSEngineConfig(**kw)
t = trp.replay(teng.TimeSurfaceEngine(tcfg, mesh=tm),
               trp.fleet_scene_feeds(H, W, 0.06, 9, seed=3, noise_hz=20.0),
               scfg(tstream), arrival_substeps=2)
assert trp.check_oracle(t, lambda: teng.TimeSurfaceEngine(tcfg, mesh=tm)) \\
    == t.n_steps
jv, tv = view(j.log), view(t.log)
assert jv == tv, next((a, b) for a, b in zip(jv, tv) if a != b)
migs = [e for k, e in t.log if k == 'migrate']
barriers = sum(1 for k, e in t.log if k == 'step' and e.barrier)
deferred = sum(len(e.deferred) for k, e in t.log if k == 'step')
print(json.dumps(dict(migrations=[list(m) for m in migs],
                      barriers=barriers, deferred=deferred,
                      steps=t.n_steps)))
print('EDF-BOTH-OK')
"""


@pytest.mark.slow
def test_multi_shard_edf_action_log_matches_reference_mesh():
    """The reference on a 2-device host mesh and the port on 2 CPU shards,
    fleet churn under ``shard_budget=2, shard_barrier_every=4``: equal
    action logs -- the least-loaded migration destinations, the barrier
    steps and the deferrals -- and the port's oracle on its sharded
    factory."""
    src = os.path.join(REPO, "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_EDF_BOTH)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, (
        f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-3000:]}")
    assert "EDF-BOTH-OK" in out.stdout
    import json
    got = json.loads(out.stdout.splitlines()[-2])
    assert len(got["migrations"]) == 3 and got["barriers"] >= 2
    assert got["deferred"] > 0
