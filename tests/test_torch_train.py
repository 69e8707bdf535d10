"""The port's LM training path (``repro_torch.train``) vs the JAX package,
on the CPU.

The reduced ``mamba2-2.7b`` (2 layers, d_model 64, 8 SSD heads x 16,
state 16, chunk 16, vocab 256, float32) in both packages; weights and
inputs drawn with numpy from a seed, the weights in the shapes and scales
of the reference's initialisers and noised where those are constant (as
``tests/test_torch_lm.py`` draws them).  Bands:

* ``decay_scan``'s backward: ``decay_scan_bwd_ref`` bitwise the kernel's
  arithmetic, equal in value to autograd of the port's ``decay_scan_ref``
  (autograd sums the per-step slices of ``a`` and ``x`` into a zero
  buffer, which turns a -0 into +0; no other bit differs).  Against
  ``jax.grad`` of the reference's ``decay_scan_ref``: the gradients of
  ``x`` and ``s0`` bitwise (the same adjoint walk), that of ``a``
  (``lam_t * s_{t-1}``) within rtol = atol = 2e-5 x max|da|, the forward's
  band (XLA's CPU code fuses ``a * s + x``, so the reference's states
  differ from the port's by a few ULP).
* ``loss_fn`` and the train step: loss within 1e-5 relative; gradients
  within rtol 1e-4 and atol 1e-4 x max|leaf| (the two packages sum inside
  contractions and cumsums in other orders).  One AdamW step: the first
  moment in the gradients' band (scaled by 1 - b1); the parameters within
  1e-4 x max|leaf| plus twice the step's lr on the cells whose gradient
  is within the band of 0 (Adam's first step is lr x sign(g) there).
* Compression: int8 ``q`` and scale bitwise, the top-k mask equal,
  ``wire_bytes`` equal.  ``TokenPipeline``: tokens bitwise.
* The in-place optimizer update (``update_``): bitwise what the
  functional ``update`` returns, which leaves its arguments as they were.
"""
import dataclasses
import os
import signal
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.distributed import fault as jfault
from repro.events.pipeline import TokenPipeline as JTokenPipeline
from repro.kernels import ref as jref
from repro.models import module as jmodule
from repro.models import transformer as jT
from repro.train import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import fault
from repro_torch.events.pipeline import TokenPipeline
from repro_torch.kernels import ops as tops
from repro_torch.kernels import decay_scan as tdecay
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.models import module as tmodule
from repro_torch.models import transformer as tT
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.grad import value_and_grad

jax.config.update("jax_platforms", "cpu")

LOSS_RTOL = 1e-5
SCAN_TOL = 2e-5     # decay_scan's band in tests/test_kernels.py
GRAD_TOL = 1e-4
JCFG = jget_config("mamba2-2.7b").reduced()
TCFG = tget_config("mamba2-2.7b").reduced()
_NOISED = {"ln1", "ln2", "ln_f", "norm", "a_log", "dt_bias", "d_skip",
           "conv_x_b", "conv_b_b", "conv_c_b", "q_norm", "k_norm"}
#: the dense family's reduced config (qk-norm, GQA) and the substrate
#: tests' TINY dense config
JDENSE = jget_config("qwen3-8b").reduced()
TDENSE = tget_config("qwen3-8b").reduced()
TINY = ModelConfig(
    name="tiny", family="dense", n_layers=2, d_model=48, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=96, vocab=128, dtype="float32",
    remat=False,
)


def _is_def(v):
    return isinstance(v, jmodule.ParamDef)


def _paths(defs):
    return [(".".join(str(p.key) for p in path), d) for path, d in
            jax.tree_util.tree_flatten_with_path(defs, is_leaf=_is_def)[0]]


def _jax_tree(defs, flat):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(defs, is_leaf=_is_def),
        [jnp.asarray(flat[k]) for k, _ in _paths(defs)])


def _flat_jax(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _weights(cfg, seed=1):
    """{path: float32 array} in the reference's initialisers' shapes and
    scales, noised where those are constant."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, d in _paths(jT.param_defs(cfg)):
        leaf = k.split(".")[-1]
        if leaf == "dt_bias":
            v = rng.uniform(-6.0, -2.0, d.shape)
        elif leaf in _NOISED:
            v = rng.standard_normal(d.shape) * 0.3
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale if d.init == "embed" else d.scale / fan_in ** 0.5
            v = rng.standard_normal(d.shape) * std
        flat[k] = v.astype(np.float32)
    return flat


def _pair(cfg_j, cfg_t, seed=1):
    flat = _weights(cfg_j, seed)
    return (_jax_tree(jT.param_defs(cfg_j), flat),
            convert.lm_params_from_numpy(flat, cfg_t, "cpu"))


def _tokens(seed, b, s, vocab=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def _grads_close(got, want):
    """Every leaf of ``got`` (the port's tree) within rtol GRAD_TOL and
    atol GRAD_TOL x max|leaf| of ``want`` ({path: array})."""
    got = {k: v.detach().numpy() for k, v in tmodule.flatten(got).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max(initial=0.0)), err_msg=k)


# ------------------------------------------------------ decay_scan backward

def _scan_inputs(btc, seed):
    b, t, c = btc
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 1.0, (b, t, c)).astype(np.float32),
            rng.standard_normal((b, t, c)).astype(np.float32),
            rng.standard_normal((b, c)).astype(np.float32),
            rng.standard_normal((b, t, c)).astype(np.float32),
            rng.standard_normal((b, c)).astype(np.float32))


@pytest.mark.parametrize("with_gf", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("btc", [(1, 1, 3), (2, 9, 70), (3, 16, 128)])
def test_decay_scan_bwd_ref_matches_autograd_and_jax(btc, with_s0, with_gf):
    a, x, s0, g, gf = _scan_inputs(btc, sum(btc))
    s0 = s0 if with_s0 else None
    gf = gf if with_gf else None
    ta, tx = torch.from_numpy(a), torch.from_numpy(x)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    ins = [v.requires_grad_(True) for v in (ta, tx) + (
        () if ts0 is None else (ts0,))]
    st, fin = tref.decay_scan_ref(ta, tx, ts0)
    outs, gs = [st], [torch.from_numpy(g)]
    if gf is not None:
        outs.append(fin)
        gs.append(torch.from_numpy(gf))
    want = torch.autograd.grad(outs, ins, gs)
    got = tref.decay_scan_bwd_ref(
        ta.detach(), st.detach(), ts0 if ts0 is None else ts0.detach(),
        torch.from_numpy(g), None if gf is None else torch.from_numpy(gf))
    got = [v for v in got if v is not None]
    assert len(got) == len(want)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
        differ = u.view(torch.int32) != v.view(torch.int32)
        assert bool((u[differ] == 0).all())    # only the sign of a zero

    def jloss(a, x, s0):
        st, fin = jref.decay_scan_ref(a, x, s0)
        out = jnp.sum(st * g)
        return out if gf is None else out + jnp.sum(fin * gf)

    argnums = (0, 1, 2) if s0 is not None else (0, 1)
    jda, *jrest = jax.grad(jloss, argnums=argnums)(a, x, s0)
    for u, v in zip(got[1:], jrest):     # dx, ds0: the same adjoint walk
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    # da = lam * s_{t-1}: the reference's forward states are its own
    # (XLA's CPU code fuses a * s + x), in decay_scan's band
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jda), rtol=SCAN_TOL,
                               atol=SCAN_TOL * float(np.abs(jda).max()))


@pytest.mark.parametrize("with_s0", [False, True])
def test_decay_scan_function_routes_backward_through_the_kernel(
        monkeypatch, with_s0):
    """``ops.decay_scan`` on a card tensor is ``DecayScan``: its forward
    and backward launch the two kernels (here replaced by their plain
    versions, counted), states carry a ``grad_fn``, a discarded final
    state counts as a zero gradient, and gradients equal autograd of the
    plain forward."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(a, x, s0=None):
        calls["fwd"] += 1
        return tref.decay_scan_ref(a.detach(), x.detach(),
                                   None if s0 is None else s0.detach())

    def bwd(*args):
        calls["bwd"] += 1
        return tref.decay_scan_bwd_ref(*args)

    monkeypatch.setattr(tdecay, "decay_scan_cuda", fwd)
    monkeypatch.setattr(tdecay, "decay_scan_bwd_cuda", bwd)
    monkeypatch.setattr(tops, "_on_card", lambda x: True)
    a, x, s0, g, _ = _scan_inputs((2, 5, 12), 3)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (a, x) + ((s0,) if with_s0 else ())]
    st, fin = tops.decay_scan(*leaves)
    assert st.grad_fn is not None and calls == {"fwd": 1, "bwd": 0}
    got = torch.autograd.grad((st * torch.from_numpy(g)).sum(), leaves)
    assert calls == {"fwd": 1, "bwd": 1}
    st_r, _ = tref.decay_scan_ref(*leaves)
    want = torch.autograd.grad((st_r * torch.from_numpy(g)).sum(), leaves)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    # only x needs a gradient: a and s0 get None
    xl = torch.from_numpy(x).requires_grad_(True)
    st, _ = tops.decay_scan(torch.from_numpy(a), xl)
    (gx,) = torch.autograd.grad(st.sum(), [xl])
    assert gx.shape == xl.shape


# ------------------------------------------------------ loss_fn and the step

@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_and_grads_match_reference(remat):
    jcfg = dataclasses.replace(JCFG, remat=remat)
    tcfg = dataclasses.replace(TCFG, remat=remat)
    jp, tp = _pair(jcfg, tcfg)
    tokens, labels = _tokens(5, 2, 40)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t, l: jT.loss_fn(p, t, l, jcfg), has_aux=True))(
            jp, tokens, labels)
    (ttot, tm), tg = value_and_grad(
        lambda p, t, l: tT.loss_fn(p, t, l, tcfg), has_aux=True)(
            tT.unstack_layers(tp), torch.from_numpy(tokens),
            torch.from_numpy(labels))
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
    assert set(tm) == set(jm) == {"loss", "lb_loss", "z_loss"}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert float(tm["lb_loss"]) == float(tm["z_loss"]) == 0.0
    stacked = {k: v for k, v in tmodule.flatten(tg).items()}
    # the unstacked layer grads, restacked, against the reference's
    want = _flat_jax(jg)
    got = {}
    for k in want:
        if k.startswith("layers."):
            got[k] = torch.stack([stacked[f"layers.{i}.{k[7:]}"]
                                  for i in range(TCFG.n_layers)])
        else:
            got[k] = stacked[k]
    _grads_close(tmodule.unflatten(got), want)


def test_forward_refuses_embeds_and_mesh():
    """A mesh is refused and ``unroll`` changes nothing; ``embeds`` are
    taken since the dense slice (held against the reference in
    ``test_train_step_with_embeds_matches_reference``)."""
    _, tp = _pair(JCFG, TCFG)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="mesh"):
        tT.forward(tp, tok, TCFG, mesh=object())
    a, _ = tT.forward(tp, tok, TCFG, unroll=True)
    b, _ = tT.forward(tp, tok, TCFG)
    assert torch.equal(a, b)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_train_step_with_microbatches_matches_reference(accum):
    """One ``make_train_step`` at n_microbatches = 2 (strided split),
    AdamW at step 10 of a 5-step warm-up, against the reference's jitted
    step from the same params, state and batch; the gradients summed in
    ``accum_dtype`` (bfloat16: the first moment within 2^-7 of its leaf's
    scale, two bfloat16 roundings of the sum)."""
    jcfg = dataclasses.replace(JCFG, n_microbatches=2, accum_dtype=accum)
    tcfg = dataclasses.replace(TCFG, n_microbatches=2, accum_dtype=accum)
    _step_against_reference(jcfg, tcfg,
                            GRAD_TOL if accum == "float32" else 2.0 ** -7)


def _step_against_reference(jcfg, tcfg, tol, embeds=None):
    """One train step of both packages from the same params, state and
    batch (and ``embeds``), held as the microbatch test holds it."""
    jp, tp = _pair(jcfg, tcfg, seed=4)
    tokens, labels = _tokens(6, 4, 24)
    temb = None if embeds is None else torch.from_numpy(embeds)
    sched = (1e-3, 5, 100)
    jo = jopt.make_optimizer("adamw", jopt.Schedule(*sched))
    to = topt.make_optimizer("adamw", topt.Schedule(*sched))
    step = 10
    # the gradients the step uses, for the band of its update
    grads, tmet = tloop.make_grad_fn(tcfg)(tp, torch.from_numpy(tokens),
                                          torch.from_numpy(labels), temb)
    gflat = {k: v.clone() for k, v in tmodule.flatten(grads).items()}
    jstep = jax.jit(jloop.make_train_step(jcfg, jo))
    jnew, jstate, jmet = jstep(jp, jo.init(jp), tokens, labels,
                               jnp.int32(step), embeds)
    tstate = to.init(tp)
    tnew, tstate, tmet2 = tloop.make_train_step(tcfg, to)(
        tp, tstate, torch.from_numpy(tokens), torch.from_numpy(labels), step,
        temb)
    for k in ("loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL)
        assert float(tmet2[k]) == float(tmet[k])
    lr = float(jopt.Schedule(*sched)(jnp.int32(step)))
    jm, jv, jpn = (_flat_jax(t) for t in (jstate["m"], jstate["v"], jnew))
    for k, w in _flat_jax(jnew).items():
        g = gflat[k].numpy()
        got_m = tmodule.flatten(tstate["m"])[k].numpy()
        np.testing.assert_allclose(
            got_m, jm[k], rtol=tol, atol=tol * float(np.abs(jm[k]).max()),
            err_msg=k)
        tiny = np.abs(g) <= 2 * tol * float(np.abs(g).max())
        band = GRAD_TOL * float(np.abs(w).max()) + np.where(tiny, 2 * lr, 0)
        err = np.abs(tmodule.flatten(tnew)[k].numpy() - w)
        assert (err <= band).all(), (k, float(err.max()))


def test_train_step_refuses_sharding():
    """A mesh is refused; ``fsdp`` and ``fsdp_gather_once`` without one
    change nothing, as in the reference (which shards only over a
    mesh)."""
    with pytest.raises(NotImplementedError, match="queue 1"):
        tloop.make_train_step(TCFG, topt.make_optimizer(
            "adamw", topt.Schedule(1e-3)), mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1"):
        tloop.Trainer(TCFG, mesh=object(), device="cpu")
    for kw in ({"fsdp": True}, {"fsdp": True, "fsdp_gather_once": True}):
        assert callable(tloop.make_grad_fn(dataclasses.replace(TCFG, **kw)))


def test_fsdp_dense_step_without_a_mesh_matches_reference():
    """A dense config with ``fsdp=True`` (every dense config of the
    registry sets it) and no mesh trains one step through
    ``make_train_step``, equal to the reference's step."""
    jcfg = dataclasses.replace(JDENSE, fsdp=True, n_microbatches=2)
    tcfg = dataclasses.replace(TDENSE, fsdp=True, n_microbatches=2)
    _step_against_reference(jcfg, tcfg, GRAD_TOL)


def test_train_step_with_embeds_matches_reference():
    """The dense step with a frontend's ``embeds`` (B, F, D), split into
    the strided microbatches with the tokens, against the reference's."""
    kw = dict(frontend="event_ts", frontend_seq=4, n_microbatches=2)
    jcfg = dataclasses.replace(JDENSE, **kw)
    tcfg = dataclasses.replace(TDENSE, **kw)
    embeds = np.random.default_rng(9).standard_normal(
        (4, 4, TDENSE.d_model)).astype(np.float32)
    _step_against_reference(jcfg, tcfg, GRAD_TOL, embeds)


# ------------------------------------------------ the in-place optimizer

def _tree_of(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (40, 16), "layers.w": (2, 16, 24), "layers.b": (2, 24),
              "layers.m": (3, 4, 6), "ln": (16,)}
    return tmodule.unflatten({
        k: torch.from_numpy((rng.standard_normal(s) * scale).astype(
            np.float32)) for k, s in shapes.items()})


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_same_bits(got, want):
    got, want = tmodule.flatten(got), tmodule.flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(
            _bits(got[k]), _bits(want[k])), k


def _in_place_against_functional(opt, params, grads_of):
    """Three steps of ``update_`` against ``update`` from the same state:
    the bits written in place are those returned, and ``update`` leaves
    its grads, state and params as they were."""
    state = opt.init(params)
    for step in range(3):   # a state that is not zeros
        grads = grads_of(step)
        before = topt._clone((grads, state, params))
        want_p, want_s = opt.update(grads, state, params, step)
        _assert_same_bits((grads, state, params), before)
        opt.update_(grads, state, params, step)
        _assert_same_bits((params, state), (want_p, want_s))


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_in_place_update_is_bitwise_the_functional_one(kind, clipped):
    opt = topt.make_optimizer(kind, topt.Schedule(3e-3, 2, 50))
    scale = 3.0 if clipped else 1e-3
    _in_place_against_functional(opt, _tree_of(0, 1.0),
                                 lambda step: _tree_of(10 + step, scale))
    norm = float(topt.global_norm(_tree_of(12, scale)))
    assert (norm > 1.0) == clipped


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_in_place_compressed_update_is_bitwise_the_functional_one(kind):
    opt = tcomp.compressed(topt.make_optimizer(
        "adamw", topt.Schedule(3e-3, 2, 50)), kind)
    _in_place_against_functional(opt, _tree_of(1, 1.0),
                                 lambda step: _tree_of(20 + step, 1.0))


# ----------------------------------------------------------- compression

def test_compression_matches_reference():
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((37, 53)) * 0.1).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, -2.5]    # halves: round to even
    q, s = tcomp.int8_compress(torch.from_numpy(g))
    jq, js = jcomp.int8_compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        tcomp.int8_decompress(q, s).numpy(),
        np.asarray(jcomp.int8_decompress(jq, js)))
    for frac in (0.05, 0.3):
        np.testing.assert_array_equal(
            tcomp.topk_mask(torch.from_numpy(g), frac).numpy(),
            np.asarray(jcomp.topk_mask(jnp.asarray(g), frac)))
    small = np.ones(16, np.float32)
    assert bool(tcomp.topk_mask(torch.from_numpy(small), 0.1).all())
    flat = _weights(JCFG)
    tp = convert.lm_params_from_numpy(flat, TCFG, "cpu")
    jp = _jax_tree(jT.param_defs(JCFG), flat)
    for kind in ("int8", "topk"):
        assert tcomp.wire_bytes(tp, kind) == jcomp.wire_bytes(jp, kind)
    with pytest.raises(ValueError):
        tcomp.compressed(topt.make_optimizer("adamw", topt.Schedule(1e-3)),
                         "fp4")


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_adamw_step_matches_reference(kind):
    """One ``compressed(adamw)`` update from the same grads, params and a
    fresh state, the reference's jitted: the residual within 1e-6 of the
    gradients' scale, the params in the step's band."""
    sched = (1e-3, 0, 100)
    jo = jcomp.compressed(jopt.adamw(jopt.Schedule(*sched)), kind)
    to = tcomp.compressed(topt.adamw(topt.Schedule(*sched)), kind)
    flat = _weights(JCFG, seed=8)
    gflat = {k: (v * 0.3).astype(np.float32)
             for k, v in _weights(JCFG, seed=9).items()}
    jp = _jax_tree(jT.param_defs(JCFG), flat)
    jg = _jax_tree(jT.param_defs(JCFG), gflat)
    tp = convert.lm_params_from_numpy(flat, TCFG, "cpu")
    tg = convert.lm_params_from_numpy(gflat, TCFG, "cpu")
    jnew, jst = jax.jit(jo.update)(jg, jo.init(jp), jp, jnp.int32(3))
    ts = to.init(tp)
    tnew, tst = to.update(tg, ts, tp, 3)
    lr = float(jopt.Schedule(*sched)(jnp.int32(3)))
    want_res = _flat_jax(jst["residual"])
    for k, v in tmodule.flatten(tst["residual"]).items():
        np.testing.assert_allclose(
            v.numpy(), want_res[k], rtol=0,
            atol=1e-6 * float(np.abs(gflat[k]).max()), err_msg=k)
    for k, w in _flat_jax(jnew).items():
        np.testing.assert_allclose(
            tmodule.flatten(tnew)[k].numpy(), w, rtol=0,
            atol=1e-4 * lr + 2e-6 * float(np.abs(w).max()), err_msg=k)


# ------------------------------------------------------ data and faults

def test_token_pipeline_matches_reference_and_resumes():
    tp, jp = TokenPipeline(50280, 3, 33, seed=4), JTokenPipeline(50280, 3,
                                                                33, seed=4)
    for _ in range(5):
        (t, l), (jt, jl) = next(tp), next(jp)
        assert t.dtype == np.int32 and l.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(l, jl)
    st = tp.state_dict()
    assert st == jp.state_dict() == {"seed": 4, "step": 5}
    want = next(jp)
    again = TokenPipeline(50280, 3, 33, seed=0)
    again.load_state_dict(st)
    got = next(again)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert iter(again) is again


def test_heartbeat_monitor():
    with tempfile.TemporaryDirectory() as td:
        hb = fault.HeartbeatMonitor(td, "host0", timeout_s=10)
        hb.beat(t=1000.0)
        other = fault.HeartbeatMonitor(td, "host1", timeout_s=10)
        other.beat(t=900.0)
        assert hb.dead_hosts(now=1005.0) == ["host1"]


def test_straggler_watchdog_matches_reference():
    dts = [1.0, 1.0, 1.0, 1.1, 9.0, 1.0]
    wd, jwd = (m.StragglerWatchdog(threshold=3.0, warmup=2)
               for m in (fault, jfault))
    flags = [wd.observe(i, dt) for i, dt in enumerate(dts)]
    assert flags == [jwd.observe(i, dt) for i, dt in enumerate(dts)]
    assert flags == [False, False, False, False, True, False]
    assert wd.flagged == [4] and wd.ema == jwd.ema and wd.ema < 2.0


def test_run_with_restarts():
    seen = []
    assert fault.run_with_restarts(
        lambda i: i if i == 2 else (_ for _ in ()).throw(ValueError(i)),
        max_restarts=3, on_restart=lambda i, e: seen.append(i)) == 2
    assert seen == [0, 1]
    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        fault.run_with_restarts(lambda i: 1 / 0, max_restarts=1)


def _reduced_tcfg(**kw):
    return tloop.TrainerConfig(**{"lr": 1e-3, "warmup_steps": 2,
                                  "decay_steps": 100, **kw})


def test_trainer_preemption_saves_and_stops():
    with tempfile.TemporaryDirectory() as td:
        tr = tloop.Trainer(TCFG, _reduced_tcfg(ckpt_dir=td, ckpt_every=1000),
                           device="cpu")
        pipe = TokenPipeline(TCFG.vocab, batch=4, seq=16, seed=0)
        tr.preempt = fault.PreemptionHandler(signals=(signal.SIGUSR1,))
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            out = tr.train(pipe, 50, pipeline=pipe)
        finally:
            tr.preempt.restore()
        assert out["final_step"] == 1
        assert tr.ckpt.latest_step() == 1


def test_trainer_restart_supervision():
    """run_with_restarts + checkpoint restore = crash recovery."""
    with tempfile.TemporaryDirectory() as td:
        crashes = {"n": 0}

        def attempt(i):
            tr = tloop.Trainer(TCFG, _reduced_tcfg(
                ckpt_dir=td, ckpt_every=2, async_ckpt=False), device="cpu")
            pipe = TokenPipeline(TCFG.vocab, batch=4, seq=16, seed=0)
            tr.maybe_restore(pipe)
            start = tr.step
            tr.train(pipe, 4 - start if start < 4 else 0, pipeline=pipe)
            if i == 0:
                crashes["n"] += 1
                raise RuntimeError("injected node failure")
            return tr.step

        final = fault.run_with_restarts(attempt, max_restarts=2)
        assert crashes["n"] == 1 and final >= 4


def test_dense_trainer_preemption_saves_and_stops():
    """``tests/test_substrate.py``'s TINY dense case on the port."""
    with tempfile.TemporaryDirectory() as td:
        tr = tloop.Trainer(TINY, tloop.TrainerConfig(ckpt_dir=td,
                                                     ckpt_every=1000),
                           device="cpu")
        pipe = TokenPipeline(TINY.vocab, batch=4, seq=16, seed=0)
        tr.preempt = fault.PreemptionHandler(signals=(signal.SIGUSR1,))
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            out = tr.train(pipe, 50, pipeline=pipe)
        finally:
            tr.preempt.restore()
        assert out["final_step"] == 1
        assert tr.ckpt.latest_step() == 1


def test_dense_trainer_restart_supervision():
    """run_with_restarts + checkpoint restore on the TINY dense config."""
    with tempfile.TemporaryDirectory() as td:
        crashes = {"n": 0}

        def attempt(i):
            tr = tloop.Trainer(TINY, tloop.TrainerConfig(
                ckpt_dir=td, ckpt_every=2, async_ckpt=False), device="cpu")
            pipe = TokenPipeline(TINY.vocab, batch=4, seq=16, seed=0)
            tr.maybe_restore(pipe)
            start = tr.step
            tr.train(pipe, 4 - start if start < 4 else 0, pipeline=pipe)
            if i == 0:
                crashes["n"] += 1
                raise RuntimeError("injected node failure")
            return tr.step

        final = fault.run_with_restarts(attempt, max_restarts=2)
        assert crashes["n"] == 1 and final >= 4


def test_dense_serve_engine_batched():
    from repro_torch.core import prng
    from repro_torch.serve.engine import Request, ServeEngine

    params = tmodule.init_params(tT.param_defs(TINY), prng.PRNGKey(0), "cpu")
    eng = ServeEngine(TINY, params, max_len=48, device="cpu")
    res = eng.serve([
        Request(np.array([1, 2, 3], np.int32), max_new_tokens=4),
        Request(np.array([9, 8], np.int32), max_new_tokens=6),
    ])
    assert res[0].tokens.shape == (4,)
    assert res[1].tokens.shape == (6,)
    assert all((r.tokens < TINY.vocab).all() for r in res)


def test_dense_serve_matches_forward_greedy():
    """Greedy generation equals repeated full-forward argmax."""
    from repro_torch.core import prng
    from repro_torch.serve.engine import Request, ServeEngine

    params = tmodule.init_params(tT.param_defs(TINY), prng.PRNGKey(3), "cpu")
    prompt = np.array([5, 17, 40], np.int32)
    eng = ServeEngine(TINY, params, max_len=32, device="cpu")
    got = eng.serve([Request(prompt, max_new_tokens=4)])[0].tokens
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(4):
            logits, _ = tT.forward(params, torch.tensor([seq]), TINY)
            seq.append(int(torch.argmax(logits[0, -1, :TINY.vocab])))
    np.testing.assert_array_equal(got, np.array(seq[len(prompt):]))


# ------------------------------------------------- checkpoints and resume

def test_tuple_tree_checkpoint_round_trips():
    tree = ({"embed": torch.arange(6.0).reshape(2, 3),
             "layers": {"w": torch.ones(2, 2)}},
            {"m": {"embed": torch.zeros(2, 3, dtype=torch.bfloat16)}})
    assert list(tmodule.flatten(tree, sep="/")) == [
        "0/embed", "0/layers/w", "1/m/embed"]
    with tempfile.TemporaryDirectory() as td:
        ck = Checkpointer(td)
        ck.save(3, tree, {"step": 3})
        files = sorted(os.listdir(os.path.join(td, "step_00000003")))
        assert "0__embed.npy" in files and "1__m__embed.npy" in files
        like = topt._map(torch.zeros_like, tree[0]), topt._map(
            torch.ones_like, tree[1])
        got, extra = ck.restore(like, device="cpu", into=True)
        assert got[0]["embed"] is like[0]["embed"] and extra == {"step": 3}
        for u, v in zip(tmodule.flatten(got).values(),
                        tmodule.flatten(tree).values()):
            assert torch.equal(u, v)


def test_trainer_resumes_a_reference_checkpoint():
    """The JAX ``Trainer`` on the reduced config trains 2 steps and saves
    ``(params, opt_state)``; the port's ``Trainer`` restores that
    directory (params, AdamW moments, step, pipeline cursor) and trains 2
    more steps, against the reference's own 2 more steps from the same
    checkpoint: losses within 1e-5 relative, params in the band of the
    step test."""
    with tempfile.TemporaryDirectory() as td:
        jtc = jloop.TrainerConfig(ckpt_dir=td, ckpt_every=1000, lr=1e-3,
                                  warmup_steps=2, decay_steps=100)
        jtr = jloop.Trainer(JCFG, jtc)
        jpipe = JTokenPipeline(JCFG.vocab, 4, 32, seed=0)
        jtr.train(jpipe, 2)
        jtr.save(jpipe)
        jtr.ckpt.wait()
        jout = jtr.train(jpipe, 2)["history"]
        ttr = tloop.Trainer(TCFG, _reduced_tcfg(ckpt_dir=td, ckpt_every=1000),
                            device="cpu", seed=5)
        tpipe = TokenPipeline(TCFG.vocab, 4, 32, seed=3)
        assert ttr.maybe_restore(tpipe) and ttr.step == 2
        assert tpipe.state_dict() == {"seed": 0, "step": 2}
        tout = ttr.train(tpipe, 2)["history"]
        assert [h["step"] for h in tout] == [2, 3]
        for h, jh in zip(tout, jout[-2:]):
            np.testing.assert_allclose(h["loss"], jh["loss"], rtol=LOSS_RTOL)
        lr = 1e-3
        for k, w in _flat_jax(jtr.params).items():
            got = tmodule.flatten(ttr.params)[k].numpy()
            np.testing.assert_allclose(
                got, w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max())
                + 2 * lr, err_msg=k)


def test_jax_checkpointer_reads_a_port_trainer_checkpoint():
    with tempfile.TemporaryDirectory() as td:
        ttr = tloop.Trainer(TCFG, _reduced_tcfg(ckpt_dir=td), device="cpu")
        ttr.train(TokenPipeline(TCFG.vocab, 2, 16, seed=0), 1)
        ttr.save()
        flat = {k: v.numpy() for k, v in tmodule.flatten(
            (ttr.params, ttr.opt_state), sep="/").items()}
        jtemplate = (_jax_tree(jT.param_defs(JCFG), {
            k[2:].replace("/", "."): v for k, v in flat.items()
            if k.startswith("0/")}),
            {"m": _jax_tree(jT.param_defs(JCFG), {
                k[4:].replace("/", "."): v for k, v in flat.items()
                if k.startswith("1/m/")}),
             "v": _jax_tree(jT.param_defs(JCFG), {
                 k[4:].replace("/", "."): v for k, v in flat.items()
                 if k.startswith("1/v/")})})
        (jp, jst), extra = JCheckpointer(td).restore(jtemplate)
        assert extra["step"] == 1
        got = {"0/" + k.replace(".", "/"): v for k, v in _flat_jax(jp).items()}
        got.update({"1/m/" + k.replace(".", "/"): v
                    for k, v in _flat_jax(jst["m"]).items()})
        got.update({"1/v/" + k.replace(".", "/"): v
                    for k, v in _flat_jax(jst["v"]).items()})
        assert set(got) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v)


# ------------------------------------------------------------------ CLI

def test_launch_train_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as td:
        tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "3",
                      "--batch", "4", "--seq", "32", "--ckpt-dir", td,
                      "--ckpt-every", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "final step 3" in out and "on cpu" in out
        tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "1",
                      "--batch", "4", "--seq", "32", "--ckpt-dir", td,
                      "--resume", "--platform", "cpu"])
        out = capsys.readouterr().out
        assert "resumed from step 3" in out and "final step 4" in out
    for kind in ("int8", "topk"):
        tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "2",
                      "--batch", "4", "--seq", "32", "--device", "cpu",
                      "--grad-compression", kind])
        assert "final step 2" in capsys.readouterr().out


@pytest.mark.parametrize("argv, words", [
    (["--production-mesh", "--device", "cpu"], ["--production-mesh"]),
    (["--platform", "tpu"], ["--platform tpu"]),
    (["--platform", "gpu", "--device", "cpu"], ["--platform gpu",
                                                "--device cpu"]),
])
def test_launch_train_refusals(capsys, argv, words):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    for w in words:
        assert w in err, err


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "1"])
