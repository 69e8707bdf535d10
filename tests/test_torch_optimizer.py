"""The port's optimizers (``repro_torch.train.optimizer``) vs the JAX
package's, on the CPU.

The same seeded numpy params, grads and state go through both packages;
the reference's ``update`` runs under ``jax.jit``, as its trainers run
it.  Bands:

* ``Schedule`` over steps 0..200: <= 2 ULP.  Under ``jit`` XLA turns the
  schedule's divisions by constants into products with their float32
  reciprocals, which the port computes; the rest is ``cos`` (XLA's and
  PyTorch's differ by 1 ULP on a few percent of inputs).
* ``global_norm``: within 1e-6 relative (the two packages sum 3,120
  squares in other orders); the clipped grads: bitwise where the norm is
  under ``max_norm`` (the scale is exactly 1), else within 2e-6 relative
  (the scale's error and the product's rounding).
* One update from the same grads, state and params, the clip off: every
  leaf within 3 ULP of the larger operand of its last sum (params also
  1e-5 of a step), not bitwise.  XLA's CPU code contracts ``b1 * m +
  (1 - b1) * g`` and ``p - lr * step`` into fused multiply-adds, rounding
  once where the port rounds twice (at most 2.5 ULP of the larger
  operand); where the two terms cancel, that is many ULPs of the result.
  Adafactor's means sum in other orders (4 ULP of ``vr`` / ``vc``) and
  its bfloat16 first moment may round the other way where the float32
  values differ (1 bfloat16 ULP).  With the clip on, twice the relative
  difference of the two packages' norms comes on top.
* One update from params at 0 and a fresh state, so that the new params
  are ``-lr * step`` and no sum can cancel: AdamW's step within 2 ULP of
  itself (the bias corrections and the quotient); Adafactor's within 10
  (its row and column means sum in other orders, 4 ULP each, and the
  factored denominator ``vr * vc / mean(vr)`` carries three of them into
  ``rsqrt``, which halves them; ``rms_u`` adds its own mean; 8 measured).
* Three updates, each package on its own trajectory from the same start
  and grads: params within 1e-3 of a step (the peak lr) of each other,
  the state within 1e-5 of each leaf's largest value (a bfloat16 ULP for
  Adafactor's first moment).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import module as jmodule
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.kernels import ref as tref
from repro_torch.models import module as tmodule
from repro_torch.models.module import ParamDef
from repro_torch.train import optimizer as topt

jax.config.update("jax_platforms", "cpu")

SCHEDULES = [(3e-3, 5, 80), (2e-3, 5, 120), (1e-3, 100, 10000)]
#: leaves of every kind the two optimizers treat apart: a conv kernel and
#: a matrix (factored for Adafactor), a small matrix (not factored, but
#: decayed by AdamW), a bias (neither)
DEFS = {
    "conv": {"w": ParamDef((3, 3, 12, 24), (None,) * 4),
             "b": ParamDef((24,), (None,))},
    "head": {"w": ParamDef((48, 10), (None, None))},
    "small": ParamDef((4, 6), (None, None)),
}
BF16_ULP = 2.0 ** -7   # relative spacing of bfloat16 values
#: the step from params at 0 (see the module docstring)
STEP_ULP = {"adamw": 2, "adafactor": 10}


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(d.shape) * scale).astype(np.float32)
            for k, d in tmodule.flatten(DEFS).items()}


def _nest(flat, fn):
    return tmodule.unflatten({k: fn(v) for k, v in flat.items()})


def _jax_flat(tree):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in tmodule.flatten(tree).items()}


def _ulp(a, b):
    return tref.ulp_distance(torch.as_tensor(np.asarray(a, np.float32)),
                             torch.as_tensor(np.asarray(b, np.float32)))


def _ulp_of(x):
    """The float32 spacing at |x|."""
    return np.spacing(np.abs(np.asarray(x, np.float32)))


def _pair(kind, schedule=SCHEDULES[0]):
    return (jopt.make_optimizer(kind, jopt.Schedule(*schedule)),
            topt.make_optimizer(kind, topt.Schedule(*schedule)))


def _random_state(kind, seed):
    """A nonzero state of the optimizer's layout, as numpy: moments as a
    few steps would leave them (second moments positive, Adafactor's
    first moment on the bfloat16 grid)."""
    _, t = _pair(kind)
    like = convert.opt_state_to_numpy(t.init(_nest(_draw(0), torch.from_numpy)))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in like.items():
        x = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        if k.startswith("v.") or k.rsplit(".", 1)[-1] in ("v", "vr", "vc"):
            x = np.abs(x) * 0.05
        if kind == "adafactor" and k.endswith(".m"):
            x = torch.from_numpy(x).bfloat16().float().numpy()
        out[k] = x
    return out


def _both_states(kind, flat_state, tparams):
    _, t = _pair(kind)
    tstate = convert.opt_state_from_numpy(flat_state, t.init(tparams))
    jstate = _nest(flat_state, jnp.asarray)
    if kind == "adafactor":   # the reference keeps m in bfloat16
        jstate = jax.tree_util.tree_map_with_path(
            lambda p, x: x.astype(jnp.bfloat16) if p[-1].key == "m" else x,
            jstate)
    return jstate, tstate


# ----------------------------------------------------------------------------
# schedule and clipping
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("args", SCHEDULES)
def test_schedule_matches_reference(args):
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jopt.Schedule(*args)))(
        jnp.asarray(steps)))
    got = topt.Schedule(*args)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert int(_ulp(got, want).max()) <= 2
    one = topt.Schedule(*args)(7)   # a Python int reads the same
    assert one.item() == got[7]


@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_global_norm_and_clip_match_reference(scale):
    flat = _draw(1, scale)
    jg, tg = _nest(flat, jnp.asarray), _nest(flat, torch.from_numpy)
    jn = float(jopt.global_norm(jg))
    tn = topt.global_norm(tg)
    assert tn.dtype == torch.float32
    assert abs(tn.item() - jn) <= 1e-6 * jn
    jc, jn2 = jax.jit(jopt.clip_by_global_norm, static_argnums=1)(jg, 1.0)
    tc, tn2 = topt.clip_by_global_norm(tg, 1.0)
    assert (jn < 1.0) == (scale == 0.01)
    for k, v in _jax_flat(jc).items():
        got = tmodule.flatten(tc)[k].numpy()
        if jn < 1.0:
            np.testing.assert_array_equal(got, flat[k])
            np.testing.assert_array_equal(got.view(np.int32),
                                          v.view(np.int32))
        else:
            np.testing.assert_allclose(got, v, rtol=2e-6, atol=0, err_msg=k)
    assert abs(tn2.item() - float(jn2)) <= 1e-6 * jn


def test_clip_is_not_clip_grad_norm():
    """max_norm / max(norm, 1e-9), not torch's max_norm / (norm + 1e-6)."""
    g = {"w": torch.full((4,), 2.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert norm.item() == 4.0
    assert torch.equal(clipped["w"], torch.full((4,), 0.5))


def test_make_optimizer_rejects_unknown_kind():
    with pytest.raises(ValueError, match="sgd"):
        topt.make_optimizer("sgd", topt.Schedule(1e-3))
    assert set(topt.make_optimizer("adamw", topt.Schedule(1e-3)).init(
        {"w": torch.zeros(2, 2)})) == {"m", "v"}


# ----------------------------------------------------------------------------
# updates
# ----------------------------------------------------------------------------

def _band(kind, key, got, want, old, grads, flat_p, lr, delta):
    """Assert the one-update band on leaf ``key``: 3 ULP of the larger
    operand of its last sum, plus twice the norms' relative difference
    ``delta`` of it (0 when the clip is off); params also 1e-5 of a
    step."""
    leaf = key.rsplit(".", 1)[-1]
    diff = np.abs(got.astype(np.float64) - want)
    if kind == "adafactor" and key not in flat_p:
        path = key.rsplit(".", 1)[0]
        if leaf == "m":   # bfloat16: at most one bfloat16 step apart
            assert (diff <= BF16_ULP * np.abs(want)).all(), key
            return
        big = np.abs(want)
        tol = (4 if leaf in ("vr", "vc") else 3) * _ulp_of(big)
    elif key.startswith("m."):
        big = np.maximum(np.float32(0.9) * np.abs(old[key]),
                         np.float32(0.1) * np.abs(grads[key[2:]]))
        tol = 3 * _ulp_of(big)
    elif key.startswith("v."):
        big = np.abs(want)
        tol = 3 * _ulp_of(big)
    else:   # params: p - lr * step
        big = np.maximum(np.abs(flat_p[key]), np.abs(want))
        tol = 3 * _ulp_of(big) + 1e-5 * lr
    tol = tol + 2 * delta * big
    assert (diff <= tol).all(), (key, float((diff / tol).max()))


@pytest.mark.parametrize("clip_on", [False, True])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_one_update_matches_reference(kind, clip_on):
    scale = 0.3 if clip_on else 0.01
    flat_p, flat_s = _draw(2), _random_state(kind, 4)
    grads = {k: (v * scale).astype(np.float32) for k, v in _draw(3).items()}
    jo, to = _pair(kind)
    jp, tp = _nest(flat_p, jnp.asarray), _nest(flat_p, torch.from_numpy)
    jstate, tstate = _both_states(kind, flat_s, tp)
    jg, tg = _nest(grads, jnp.asarray), _nest(grads, torch.from_numpy)
    jn = float(jax.jit(jopt.global_norm)(jg))
    assert (jn > 1.0) == clip_on
    delta = abs(float(topt.global_norm(tg)) - jn) / jn if clip_on else 0.0
    jp2, js2 = jax.jit(jo.update)(jg, jstate, jp, jnp.int32(3))
    tp2, ts2 = to.update(tg, tstate, tp, torch.tensor(3, dtype=torch.int32))
    lr = float(topt.Schedule(*SCHEDULES[0])(3))
    got = {**convert.opt_state_to_numpy(ts2), **convert.params_to_numpy(tp2)}
    for key, want in {**_jax_flat(js2), **_jax_flat(jp2)}.items():
        assert got[key].dtype == np.float32
        _band(kind, key, got[key], want, flat_s, grads, flat_p, lr, delta)
    # the inputs are left as they were
    for k, v in convert.params_to_numpy(tp).items():
        np.testing.assert_array_equal(v, flat_p[k])
    if kind == "adafactor":
        assert all(v.dtype == torch.bfloat16 for k, v in
                   tmodule.flatten(ts2).items() if k.endswith(".m"))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_one_update_from_zero_params_holds_the_step(kind):
    """Params at 0 and a fresh state: the new params are ``-lr * step``
    (AdamW's decay term is 0, and no moment sum can cancel), so the
    normalised step itself is held to a few ULP of its own size."""
    flat_p = {k: np.zeros_like(v) for k, v in _draw(2).items()}
    grads = {k: (v * 0.01).astype(np.float32) for k, v in _draw(3).items()}
    jo, to = _pair(kind)
    jp, tp = _nest(flat_p, jnp.asarray), _nest(flat_p, torch.from_numpy)
    jg, tg = _nest(grads, jnp.asarray), _nest(grads, torch.from_numpy)
    jp2, _ = jax.jit(jo.update)(jg, jo.init(jp), jp, jnp.int32(3))
    tp2, _ = to.update(tg, to.init(tp), tp, torch.tensor(3, dtype=torch.int32))
    got = convert.params_to_numpy(tp2)
    for key, want in _jax_flat(jp2).items():
        assert (want != 0).all(), key
        assert int(_ulp(got[key], want).max()) <= STEP_ULP[kind], key


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_updates_match_reference(kind):
    """Each package on its own trajectory from the same start, the same
    grads each step (clip on at step 0, off after)."""
    jo, to = _pair(kind)
    flat_p = _draw(5)
    jp, tp = _nest(flat_p, jnp.asarray), _nest(flat_p, torch.from_numpy)
    js, ts_ = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for i, scale in enumerate((0.3, 0.01, 0.05)):
        g = {k: (v * scale).astype(np.float32) for k, v in _draw(6 + i).items()}
        jp, js = update(_nest(g, jnp.asarray), js, jp, jnp.int32(i))
        tp, ts_ = to.update(_nest(g, torch.from_numpy), ts_, tp,
                            torch.tensor(i, dtype=torch.int32))
    lr_peak = SCHEDULES[0][0]
    got = convert.params_to_numpy(tp)
    for key, want in _jax_flat(jp).items():
        step_units = np.abs(got[key].astype(np.float64) - want) / lr_peak
        assert step_units.max() <= 1e-3, (key, float(step_units.max()))
    got_s = convert.opt_state_to_numpy(ts_)
    for key, want in _jax_flat(js).items():
        scale = max(float(np.abs(want).max()), 1e-30)
        tol = BF16_ULP if key.endswith(".m") and kind == "adafactor" \
            else 1e-5
        assert np.abs(got_s[key] - want).max() <= tol * scale, key


def test_opt_state_carriers_round_trip_bitwise():
    tp = _nest(_draw(8), torch.from_numpy)
    for kind in ("adamw", "adafactor"):
        _, to = _pair(kind)
        like = to.init(tp)
        flat = _random_state(kind, 9)
        state = convert.opt_state_from_numpy(flat, like)
        for k, v in tmodule.flatten(state).items():
            assert v.dtype == tmodule.flatten(like)[k].dtype, k
        back = convert.opt_state_to_numpy(state)
        assert set(back) == set(flat)
        for k, v in back.items():
            np.testing.assert_array_equal(v.view(np.int32),
                                          flat[k].view(np.int32))
        with pytest.raises(KeyError, match="missing"):
            convert.opt_state_from_numpy(
                {k: v for k, v in flat.items() if k != sorted(flat)[0]}, like)
        bad = dict(flat)
        bad[sorted(flat)[0]] = np.zeros((1,), np.float32)
        with pytest.raises(ValueError, match=sorted(flat)[0]):
            convert.opt_state_from_numpy(bad, like)
    flat = _draw(10)
    params = convert.params_from_numpy(flat, DEFS, "cpu")
    for k, v in convert.params_to_numpy(params).items():
        np.testing.assert_array_equal(v.view(np.int32), flat[k].view(np.int32))
    with pytest.raises(ValueError, match="head.w"):
        convert.params_from_numpy(dict(flat, **{"head.w": np.zeros((2, 2))}),
                                  DEFS, "cpu")
