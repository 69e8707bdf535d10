"""The port's stage-1 heads, quantized reads and ``sensors`` CLI vs the
JAX package, on the CPU.

The same seeded numpy inputs go through both packages.  Bands:

* ``cnn_apply`` and ``event_ts_frontend``: rtol 1e-4, atol 1e-4 x
  max(1, max|ref|) in float32 -- ``F.conv2d`` and XLA's convolution sum
  in other orders, and the surfaces they read may differ by 2 ULP;
* ``ts_stack_frontend``, ``ts_quantize_sae``: bitwise (pure layout, exact
  integer arithmetic);
* ``ts_wrapped_read``: <= 2 ULP of the reference's oracle
  ``ref.ts_wrapped_read_ref`` (the two ``exp``s), the modular ages equal;
* engine reads: the stage-0 products in ``test_torch_engine.py``'s bands
  (decay <= 2 ULP, masks, supports and labels exact away from the
  comparator threshold), logits in the CNN band.

The reference's weights are carried across through the head registry,
through ``convert.head_params_from_numpy`` and through a checkpoint
directory; the two packages' ``"default"`` weights (and ``init_params``
on a head's defs) are held within ``prng.normal``'s 4 ULP of each other,
their per-leaf keys bitwise.  Inside the port the staged
contracts hold bitwise: a head-bearing ``read`` == ``read_many`` with its
stage-0 read shared, ``Classify`` == ``ref.classify_ref`` on the served
surfaces, ``Denoise`` == ``stcf >= threshold``, and the offline
``ts_sram_quantized`` == the engine's ``TsQuantized`` on equal stamps.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.core import edram as jedram
from repro.events import aer as jaer
from repro.events import datasets as jdatasets
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro.models import frontends as jfront
from repro.models import module as jmodule
from repro.serve import heads as jheads
from repro.serve import spec as jspec
from repro.serve import ts_engine as jeng
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as tget_config
from repro_torch.core import edram as tedram
from repro_torch.core import prng as tprng
from repro_torch.core import representations as trep
from repro_torch.core import time_surface as tts
from repro_torch.events import aer as taer
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import cnn as tcnn
from repro_torch.models import frontends as tfront
from repro_torch.models import module as tmodule
from repro_torch.serve import heads as theads
from repro_torch.serve import spec as tspec
from repro_torch.serve import ts_engine as teng

jax.config.update("jax_platforms", "cpu")

H, W, S, CAP = 26, 35, 3, 128
CNN_TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    jheads.clear_registry()
    theads.clear_registry()


def _draw(defs, seed):
    """A JAX param tree for ``defs`` drawn with numpy (fan-in scaled
    normals, biases included): the reference's weights, made without
    compiling ``jax.random`` for every leaf shape."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        scale = 1.0 / np.sqrt(d.shape[-2] if len(d.shape) >= 2 else 1)
        return jnp.asarray((rng.standard_normal(d.shape) * scale)
                           .astype(np.float32))
    return jax.tree_util.tree_map(leaf, defs)


def _np_tree(tree):
    """{"/"-joined leaf path: numpy array} of a JAX param tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_cnn_band(got, want):
    got = torch.as_tensor(got).float().cpu()
    want = torch.from_numpy(np.array(want, np.float32))
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=CNN_TOL, atol=CNN_TOL * scale), (
        float((got - want).abs().max()), scale)


def _ulp(a, b):
    return tref.ulp_distance(torch.as_tensor(np.array(a, np.float32)),
                             torch.as_tensor(np.array(b, np.float32)))


# ----------------------------------------------------------------------------
# the CNN and the frontends
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("hw", [(24, 32), (23, 37)])
def test_cnn_apply_matches_reference(hw, k, p):
    """Even and odd planes: XLA's "SAME" padding is asymmetric there."""
    h, w = hw
    jp = _draw(jcnn.cnn_defs(k * p, 5, width=8), k + p)
    x = np.random.default_rng(k * 10 + p).random((2, h, w, k * p),
                                                 dtype=np.float32)
    want = jcnn.cnn_apply(jp, jnp.asarray(x))
    got = tcnn.cnn_apply(_torch_tree(jp), torch.from_numpy(x))
    _assert_cnn_band(got, want)


def test_cnn_same_padding_is_xla_s():
    """The stem on 240 rows pads 1 above and 2 below, on 39 rows 2 and 2;
    the stride-2 pool pads 0/1 on an even side, 1/1 on an odd one."""
    assert tcnn._same(240, 5, 2) == (1, 2) and tcnn._same(39, 5, 2) == (2, 2)
    assert tcnn._same(120, 3, 2) == (0, 1) and tcnn._same(39, 3, 2) == (1, 1)
    assert tcnn._same(7, 3, 1) == (1, 1) and tcnn._same(5, 1, 1) == (0, 0)


def test_ts_stack_frontend_bitwise():
    rng = np.random.default_rng(0)
    surfaces = [rng.random((3, 2, 5, 7), dtype=np.float32) for _ in range(3)]
    want = np.asarray(jfront.ts_stack_frontend(
        [jnp.asarray(s) for s in surfaces]))
    got = tfront.ts_stack_frontend([torch.from_numpy(s) for s in surfaces])
    assert got.shape == want.shape == (3, 5, 7, 6)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("edram", [False, True])
def test_event_ts_frontend_matches_reference(edram):
    kw = dict(d_model=32, frontend_seq=12, dtype="float32")
    jcfg = dataclasses.replace(jget_config("mamba2-2.7b").reduced(), **kw)
    tcfg = dataclasses.replace(tget_config("mamba2-2.7b").reduced(), **kw)
    jp = _draw(jfront.event_ts_frontend_defs(jcfg, patch=4, polarities=2), 3)
    rng = np.random.default_rng(3)
    sae = (rng.random((2, 2, 18, 21)) * 0.05).astype(np.float32)
    sae[rng.random(sae.shape) < 0.3] = -np.inf
    jdecay = jedram.decay_params_for_cmem() if edram else None
    tdecay = tedram.decay_params_for_cmem() if edram else None
    want = jfront.event_ts_frontend(jp, jnp.asarray(sae), 0.05, jcfg,
                                    decay=jdecay, patch=4)
    got = tfront.event_ts_frontend(_torch_tree(jp), torch.from_numpy(sae),
                                   0.05, tcfg, decay=tdecay, patch=4)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 32)
    _assert_cnn_band(got, want)


# ----------------------------------------------------------------------------
# the spec's products
# ----------------------------------------------------------------------------

def test_heads_and_quantized_products_construct():
    spec = tspec.ReadoutSpec(surface=tspec.surface(), stcf=tspec.stcf(),
                             q=tspec.ts_quantized(n_bits=8, tick=1e-4),
                             logits=tspec.classify(n_classes=3, width=8),
                             labels=tspec.denoise())
    assert spec.has_heads
    assert [n for n, _ in spec.head_products()] == ["labels", "logits"]
    assert spec.stage0() == tspec.ReadoutSpec(
        surface=tspec.surface(), stcf=tspec.stcf(),
        q=tspec.ts_quantized(n_bits=8, tick=1e-4))
    plain = tspec.ReadoutSpec(surface=tspec.surface())
    assert not plain.has_heads and plain.stage0() is plain
    plan = tspec.compile_spec(spec, teng.TSEngineConfig(h=H, w=W))
    assert plan.has_heads and plan.stage0 == spec.stage0()
    assert set(plan.dynamic) == {"surface", "stcf", "q"}


def test_head_wiring_and_ranges_validated_at_construction():
    rs = tspec
    with pytest.raises(ValueError, match="does not define"):
        rs.ReadoutSpec(logits=rs.classify())
    with pytest.raises(ValueError, match="needs a Surface"):
        rs.ReadoutSpec(surface=rs.stcf(), logits=rs.classify())
    with pytest.raises(ValueError, match="needs a Stcf"):
        rs.ReadoutSpec(stcf=rs.surface(), labels=rs.denoise())
    with pytest.raises(ValueError, match="cannot consume"):
        rs.ReadoutSpec(stcf=rs.stcf(), surface=rs.denoise(),
                       logits=rs.classify())
    with pytest.raises(TypeError, match="bare string"):
        rs.classify(inputs="surface")
    with pytest.raises(ValueError, match="at least one input"):
        rs.classify(inputs=())
    with pytest.raises(ValueError, match="n_bits"):
        rs.ReadoutSpec(q=rs.ts_quantized(n_bits=25))
    with pytest.raises(ValueError, match="tick"):
        rs.ReadoutSpec(q=rs.ts_quantized(tick=0.0))
    with pytest.raises(TypeError, match="must be one of"):
        rs.ReadoutSpec(q=jspec.TsQuantized())     # the JAX package's


# ----------------------------------------------------------------------------
# engine reads vs the JAX engine
# ----------------------------------------------------------------------------

def _specs(module, key):
    def make(m):
        return m.ReadoutSpec(
            surface=m.Surface(), fast=m.Surface(mode="ideal", tau=5e-3),
            mask=m.Mask(), stcf=m.Stcf(), count=m.Count(4), ebbi=m.Ebbi(),
            q=m.TsQuantized(n_bits=8, tick=1e-4),
            logits=m.Classify(inputs=("surface", "fast"), weights=key,
                              n_classes=4, width=8),
            labels=m.Denoise())
    return make(jspec), make(tspec)


def _head_engines(mode, key):
    jsp, tsp = _specs(None, key)
    kw = dict(h=H, w=W, polarities=2, n_slots=S, chunk_capacity=CAP,
              mode=mode)
    je = jeng.TimeSurfaceEngine(jeng.TSEngineConfig(**kw, backend="ref",
                                                    specs=(jsp,)))
    te = teng.TimeSurfaceEngine(teng.TSEngineConfig(**kw, specs=(tsp,)),
                                device="cpu")
    for _ in range(S):
        je.attach(), te.attach()
    head = jsp["logits"]
    jp = _draw(jheads.head_param_defs(head, je.cfg), 7)
    jheads.register_head_params(key, jp)
    theads.register_head_params(key, convert.head_params_from_numpy(
        _np_tree(jp), tsp["logits"], te.cfg, device="cpu"))
    return je, te, jsp, tsp


def _words(seed, lo, hi):
    kind = ("driving", "hotel_bar")[seed % 2]
    return jaer.pack(jdatasets.dnd21_like(kind, H, W, 0.06, seed=seed)
                     .window(lo, hi))


def _assert_heads_read_in_band(jout, tout, cfg, t_now, jsae):
    assert list(tout) == list(jout)
    v_tw = cfg.v_tw()
    surf = np.asarray(jout["surface"])
    near = _ulp(surf, np.full_like(surf, np.float32(v_tw))).numpy() <= 4
    near_patch = tref.stcf_support_ref(torch.from_numpy(near),
                                       cfg.stcf_radius,
                                       include_self=True).numpy() > 0
    assert near_patch.mean() < 1e-2
    for name, got in tout.items():
        want = np.asarray(jout[name])
        assert tuple(got.shape) == want.shape, name
        got = got.numpy()
        if name in ("surface", "fast"):
            assert _ulp(got, want).max() <= 2, name
        elif name == "mask":
            np.testing.assert_array_equal(got[~near], want[~near])
        elif name in ("stcf", "labels"):
            np.testing.assert_array_equal(got[~near_patch], want[~near_patch])
        elif name == "logits":
            _assert_cnn_band(got, want)
        elif name == "q":     # against the oracle on the reference's SAE
            oracle = jref.ts_wrapped_read_ref(
                jops.ts_quantize_sae(jsae, n_bits=8, tick=1e-4), t_now,
                cfg.tau, n_bits=8, tick=1e-4)
            assert _ulp(got, oracle).max() <= 2
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mode", ["edram", "ideal"])
def test_engine_heads_match_reference(mode):
    je, te, jsp, tsp = _head_engines(mode, f"heads-{mode}")
    t_now = 0.06
    items = [(s, _words(50 + s, 0.0, 0.03)) for s in range(S)]
    je.push(items)
    te.push(items)
    _assert_heads_read_in_band(je.read(jsp, t_now), te.read(tsp, t_now),
                               te.cfg, t_now, je.state.surfaces.sae)
    items = [(s, _words(50 + s, 0.03, 0.06)) for s in range(S)]
    jout = je.serve_step(items, jsp, t_now)
    tout = te.serve_step(items, tsp, t_now)
    _assert_heads_read_in_band(jout, tout, te.cfg, t_now,
                               je.state.surfaces.sae)
    assert tout["logits"].shape == (S, 4)
    assert tout["labels"].dtype == torch.bool


def test_engine_ts_quantized_within_2_ulp_of_oracle():
    _, te, _, tsp = _head_engines("edram", "q")
    te.push([(s, _words(60 + s, 0.0, 0.06)) for s in range(S)])
    t_now = 0.06
    got = te.read(tsp, t_now)["q"]
    stored = tops.ts_quantize_sae(te.state.surfaces.sae, n_bits=8, tick=1e-4)
    want = np.array(jref.ts_wrapped_read_ref(
        jnp.asarray(stored.numpy()), t_now, te.cfg.tau, n_bits=8, tick=1e-4))
    assert int(tref.ulp_distance(got, torch.from_numpy(want)).max()) <= 2
    # 60 ms of events against a 25.6 ms wrap period: stamps older than a
    # period alias as recent and read above the unwrapped surface
    sae = te.state.surfaces.sae
    old = torch.isfinite(sae) & (t_now - sae >= 256 * 1e-4)
    assert old.any()
    assert (got[old] > tts.ts_ideal(sae, t_now, te.cfg.tau)[old]).any()


# ----------------------------------------------------------------------------
# staged contracts inside the port
# ----------------------------------------------------------------------------

def _loaded_port_engine(key="staged"):
    _, te, _, tsp = _head_engines("edram", key)
    te.push([(s, _words(70 + s, 0.0, 0.05)) for s in range(S - 1)])
    return te, tsp


def test_read_many_shares_stage0_bitwise(monkeypatch):
    te, tsp = _loaded_port_engine()
    rs = tspec
    s0 = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf())
    a = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf(),
                       logits=rs.classify(n_classes=3, width=8))
    b = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf(),
                       labels=rs.denoise())
    stage0_reads = []
    real = rs.read_stage0
    monkeypatch.setattr(rs, "read_stage0", lambda *args: stage0_reads.append(
        args[3].spec) or real(*args))
    got = te.read_many([a, s0, b, a, tsp], 0.05)
    assert list(got) == [a, s0, b, tsp]
    assert stage0_reads == [s0, tsp]          # one stage-0 read per group
    for sp in (a, s0, b, tsp):
        want = te.read(sp, 0.05)
        assert tuple(got[sp]) == sp.names
        for name in want:
            assert torch.equal(got[sp][name], want[name]), (name, sp)


def test_heads_equal_their_plain_versions():
    te, tsp = _loaded_port_engine()
    out = te.read(tsp, 0.05)
    params = theads.resolve_head_params(tsp["logits"], te.cfg, "cpu")
    assert torch.equal(out["logits"], tref.classify_ref(
        params, [out["surface"], out["fast"]]))
    assert torch.equal(out["labels"],
                       tref.denoise_ref(out["stcf"], te.cfg.stcf_threshold))
    base = te.read(tsp.stage0(), 0.05)          # heads leave stage 0 as is
    for name in base:
        assert torch.equal(out[name], base[name]), name


def test_serve_step_with_heads_matches_read():
    te, tsp = _loaded_port_engine()
    served = te.serve_step([(2, _words(80, 0.0, 0.05))], tsp, 0.05)
    again = te.read(tsp, 0.05)
    for name in tsp.names:
        assert torch.equal(served[name], again[name]), name
    assert te.stats()["cache_t"] is None     # heads bypass the tile cache


def test_offline_ts_sram_quantized_equals_engine_product():
    """Stamps within one 25.6 ms wrap period (quantizing the maxed SAE and
    maxing quantized stamps then agree), read at 60 ms (the read wraps)."""
    words = _words(90, 0.0, 0.02)
    eng = teng.TimeSurfaceEngine(teng.TSEngineConfig(
        h=H, w=W, n_slots=1, chunk_capacity=4096, mode="ideal",
        tau=0.01), device="cpu")
    eng.attach().push(words)
    spec = tspec.ReadoutSpec(q=tspec.ts_quantized(n_bits=8, tick=1e-4))
    served = eng.read(spec, 0.06)["q"][0]
    s = taer.unpack(words, H, W)
    ev = tts.EventBatch(*(torch.from_numpy(f.astype(d)) for f, d in (
        (s.x, np.int32), (s.y, np.int32), (s.t, np.float32),
        (s.p, np.int32))), valid=torch.ones(s.n, dtype=torch.bool))
    offline = trep.ts_sram_quantized(ev, H, W, 0.06, 0.01, n_bits=8,
                                     tick=1e-4)
    assert torch.equal(served.view(torch.int32), offline.view(torch.int32))
    assert (offline > 0).any()


# ----------------------------------------------------------------------------
# quantized reads vs the reference
# ----------------------------------------------------------------------------

def _wrapped_case(seed):
    """The inputs ``tests/test_kernel_equivalence.py::check_ts_wrapped_read``
    draws at this seed."""
    rng = np.random.default_rng((seed, zlib.crc32(b"check_ts_wrapped_read")))
    h, w = int(rng.integers(1, 64)), int(rng.integers(1, 128))
    n_bits = int(rng.choice([8, 12, 16]))
    tick = float(rng.choice([1e-4, 1e-3]))
    tau = float(rng.uniform(0.005, 0.1))
    t_read = float(rng.uniform(0.0, 2.0))
    frac_never = rng.choice([0.0, 0.3, 1.0], p=[0.3, 0.5, 0.2])
    t = rng.random((1, h, w)).astype(np.float32) * 1.5
    sae = np.where(rng.random((1, h, w)) < frac_never, -np.inf, t)
    return sae.astype(np.float32), n_bits, tick, tau, t_read


@pytest.mark.parametrize("seed", range(6))
def test_ts_quantize_sae_bitwise(seed):
    sae, n_bits, tick, _, _ = _wrapped_case(seed)
    want = np.asarray(jops.ts_quantize_sae(jnp.asarray(sae), n_bits=n_bits,
                                           tick=tick))
    got = tops.ts_quantize_sae(torch.from_numpy(sae), n_bits=n_bits,
                               tick=tick)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_ts_wrapped_read_within_2_ulp_of_oracle(seed):
    """Against the reference's oracle, not its interpret backend (which is
    up to 62 ULP and a whole period off at seed 5: ROADMAP queue 3).  The
    modular age is the oracle's at every cell -- 0 cells a period off at
    a wrap boundary -- so the decay's ``exp`` is the only difference."""
    sae, n_bits, tick, tau, t_read = _wrapped_case(seed)
    stored = jops.ts_quantize_sae(jnp.asarray(sae), n_bits=n_bits, tick=tick)
    want = np.array(jref.ts_wrapped_read_ref(stored, t_read, tau,
                                               n_bits=n_bits, tick=tick))
    stored_t = torch.from_numpy(np.array(stored))
    got = tops.ts_wrapped_read(stored_t, t_read, trep.edram_ideal_params(tau),
                               n_bits=n_bits, tick=tick)
    assert int(tref.ulp_distance(got, torch.from_numpy(want)).max()) <= 2
    period = (2 ** n_bits) * tick
    t_read_w = jnp.float32(jnp.floor(jnp.float32(t_read) / tick)
                           % (2 ** n_bits)) * tick
    ref_age = np.asarray(jnp.mod(t_read_w - stored, period))
    age = tref.wrapped_age(stored_t, t_read, n_bits, tick).numpy()
    fin = np.isfinite(sae)
    off_by_a_period = int((age[fin] != ref_age[fin]).sum())
    assert off_by_a_period == 0
    assert torch.equal(tref.ts_wrapped_read_ref(stored_t, t_read, tau,
                                                n_bits, tick) == 0,
                       torch.from_numpy(~fin))


# ----------------------------------------------------------------------------
# head weights
# ----------------------------------------------------------------------------

def _cfg(**kw):
    return teng.TSEngineConfig(h=H, w=W, n_slots=3, chunk_capacity=256, **kw)


def test_head_weights_registry_checkpoint_and_default(tmp_path):
    cfg = _cfg()
    head = tspec.classify(n_classes=3, width=8)
    jp = _draw(jheads.head_param_defs(head, cfg), 1)
    want = _np_tree(jp)
    # the registry
    theads.register_head_params("reg", convert.head_params_from_numpy(
        want, head, cfg, device="cpu"))
    got = theads.resolve_head_params(dataclasses.replace(head, weights="reg"),
                                     cfg, "cpu")
    for k, v in convert.head_params_to_numpy(got).items():
        np.testing.assert_array_equal(v.view(np.int32), want[k].view(np.int32))
    # a checkpoint directory the reference wrote
    JCheckpointer(str(tmp_path)).save(4, jp)
    got = theads.resolve_head_params(
        dataclasses.replace(head, weights=str(tmp_path)), cfg, "cpu")
    for k, v in convert.head_params_to_numpy(got).items():
        np.testing.assert_array_equal(v.view(np.int32), want[k].view(np.int32))
    # "default": deterministic, the reference's shapes
    d1 = theads.resolve_head_params(head, cfg, "cpu")
    d2 = theads.resolve_head_params(head, cfg, "cpu")
    flat = tmodule.flatten(d1)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in
        tmodule.flatten(theads.head_param_defs(head, cfg)).items()}
    assert all(torch.equal(a, b) for a, b in zip(
        flat.values(), tmodule.flatten(d2).values()))
    with pytest.raises(KeyError, match="neither registered"):
        theads.resolve_head_params(
            dataclasses.replace(head, weights="nope"), cfg, "cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(KeyError, match="neither registered"):
        theads.resolve_head_params(
            dataclasses.replace(head, weights=str(empty)), cfg, "cpu")


NORMAL_ULP = 4   # prng.normal's band (tests/test_torch_fidelity.py)


@pytest.mark.parametrize("how", ["init_params", "default"])
def test_head_weights_match_reference(how):
    """``init_params`` on a ``Classify`` head's defs, and the
    ``"default"`` weights (``init_params`` on ``PRNGKey(crc32(geometry))``
    in both packages), within 4 ULP of the reference's on every leaf, the
    per-leaf keys bitwise."""
    cfg = _cfg(polarities=2)
    jcfg = jeng.TSEngineConfig(h=H, w=W, n_slots=3, chunk_capacity=256,
                               polarities=2)
    head = tspec.classify(n_classes=3, width=8)
    jhead = jspec.classify(n_classes=3, width=8)
    if how == "default":
        seed = zlib.crc32(b"1:2:3:8")
        got = theads.resolve_head_params(head, cfg, "cpu")
        want = jheads.resolve_head_params(jhead, jcfg)
    else:
        seed = 5
        got = tmodule.init_params(theads.head_param_defs(head, cfg),
                                  tprng.PRNGKey(seed), "cpu")
        want = jmodule.init_params(jheads.head_param_defs(jhead, jcfg),
                                   jax.random.PRNGKey(seed))
    got, want = convert.head_params_to_numpy(got), _np_tree(want)
    assert set(got) == set(want)
    np.testing.assert_array_equal(
        tprng.split(tprng.PRNGKey(seed), len(want)).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(
            jax.random.PRNGKey(seed), len(want)))).astype(np.int64))
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        assert int(_ulp(v, want[k]).max()) <= NORMAL_ULP, k


def test_head_params_from_numpy_checks_leaves():
    cfg = _cfg()
    head = tspec.classify(n_classes=3, width=8)
    arrays = convert.head_params_to_numpy(
        theads.resolve_head_params(head, cfg, "cpu"))
    assert "inc1/b3a/w" in arrays
    bad = dict(arrays, **{"head/w": np.zeros((5, 3), np.float32)})
    with pytest.raises(ValueError, match="head/w"):
        convert.head_params_from_numpy(bad, head, cfg, "cpu")
    with pytest.raises(KeyError):
        convert.head_params_from_numpy(
            {k: v for k, v in arrays.items() if k != "stem/b"}, head, cfg,
            "cpu")


def test_checkpoint_cache_not_poisoned_across_geometries(tmp_path):
    """Two heads naming one checkpoint directory but differing in geometry
    never share a cached restore: the mismatched one fails the template's
    shape check."""
    cfg = _cfg()
    head3 = tspec.classify(weights=str(tmp_path), n_classes=3, width=8)
    p3 = tmodule.init_params(theads.head_param_defs(head3, cfg),
                             tprng.PRNGKey(1), "cpu")
    Checkpointer(str(tmp_path)).save(1, p3)
    want = tmodule.flatten(p3)
    got = theads.resolve_head_params(head3, cfg, "cpu")
    assert all(torch.equal(a, want[k]) for k, a in
               tmodule.flatten(got).items())
    head5 = tspec.classify(weights=str(tmp_path), n_classes=5, width=8)
    with pytest.raises(ValueError, match="head/"):
        theads.resolve_head_params(head5, cfg, "cpu")
    again = theads.resolve_head_params(head3, cfg, "cpu")
    assert all(torch.equal(a, want[k]) for k, a in
               tmodule.flatten(again).items())


def test_checkpoint_cache_tracks_new_steps(tmp_path):
    """A newly saved step is served at the next resolve; the same step
    resolves from the cache (one restore, the same object)."""
    cfg = _cfg()
    head = tspec.classify(weights=str(tmp_path), n_classes=3, width=8)
    defs = theads.head_param_defs(head, cfg)
    p1, p2 = (tmodule.init_params(defs, tprng.PRNGKey(s), "cpu")
              for s in (10, 11))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, p1)
    first = theads.resolve_head_params(head, cfg, "cpu")
    ck.save(2, p2)
    second = theads.resolve_head_params(head, cfg, "cpu")
    for got, want in ((first, p1), (second, p2)):
        w = tmodule.flatten(want)
        assert all(torch.equal(a, w[k]) for k, a in
                   tmodule.flatten(got).items())
    assert (theads.resolve_head_params(head, cfg, "cpu")
            is theads.resolve_head_params(head, cfg, "cpu"))


# ----------------------------------------------------------------------------
# the sensors CLI
# ----------------------------------------------------------------------------

def test_sensors_cli_on_cpu(capsys):
    tlaunch.main(["sensors", "--hw", "48x64", "--duration", "0.03",
                  "--sensors", "2", "--chunk", "1024", "--classify", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fused surface bit-identical to dense readout: True" in out
    assert out.count("logits argmax") == 2 and "on CPU" in out


def test_sensors_cli_mesh_on_cpu(capsys):
    """``sensors --mesh 2`` on two CPU shards: the placement and the
    padded pool printed, the fused surface bitwise the dense read."""
    tlaunch.main(["sensors", "--mesh", "2", "--hw", "48x64", "--duration",
                  "0.03", "--sensors", "3", "--slots", "5", "--chunk", "1024",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 2} -- shard 0 -> cpu, shard 1 -> cpu" in out
    assert "slot pool padded 5 -> 6 for 2 shards" in out
    assert "fused surface bit-identical to dense readout: True" in out


def test_sensors_cli_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["sensors", "--hw", "48x64", "--classify", "3"])
