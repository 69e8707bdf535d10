"""The repro_torch MoE family vs the JAX package, on the CPU.

``grok-1-314b`` (8 experts, top-2) and ``kimi-k2-1t-a32b`` (384 experts,
top-8, one shared expert) at ``reduced()`` in both packages: 2 layers,
d_model 64, 4 experts of d_ff 64, top-2 (kimi's shared expert of 64),
vocab 256, float32.  Weights and inputs are drawn with numpy from a seed
and cross into the port through ``repro_torch.convert``; the leaves the
reference initialises to zeros are noised, and the attention projections
are drawn at their true fan-in, as ``tests/test_torch_dense.py`` draws
them and says why.

Bands: ``route``'s ``top_idx`` bitwise (ties to the lower index, as
``jax.lax.top_k`` breaks them); on router inputs whose logits are exact
in float32, ``top_w`` within 4 ULP (the packages' ``exp`` differ by up
to 2, the renormalisation adds 2) and ``lb_loss`` and ``z_loss`` within
4 ULP (sums over the tokens in another order); on float inputs, whose
logits differ in their last bits, all three within 2e-6 relative;
``capacity`` exact.  ``moe_dense`` in float32
within rtol = 1e-5, atol = 1e-5 x max(1, max|want|) (the experts' sums
inside contractions in another order); in bf16 within
``BF16_TOL`` x max|want| (a bf16 product one ulp apart in an expert's
hidden layer moves the output by a bf16 ulp of its terms).  The stack as
``tests/test_torch_dense.py``'s: logits rtol 2e-5, atol 2e-5 x max(1,
max|want|); ``lb_loss`` and ``z_loss`` of ``forward`` within 1e-5
relative, greedy tokens equal.  Gradients of ``loss_fn`` against
``jax.grad`` within rtol 1e-4, atol 1e-4 x max|leaf|
(``tests/test_torch_train.py``'s); the ``Trainer`` step's update of each
cell within ``UPDATE_TOL`` of its leaf's largest.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import module as jmodule
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.events.pipeline import TokenPipeline
from repro_torch.kernels import ref as tref
from repro_torch.models import module as tmodule
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine
from repro_torch.train import loop as tloop

jax.config.update("jax_platforms", "cpu")

TOL = 2e-5
MOE_TOL = 1e-5
GRAD_TOL = 1e-4
#: an Adafactor update against the reference's, a fraction of its leaf's
#: largest: the gradients summed in bf16 and the bf16 momentum round the
#: update of a cell to 8 bits three times, 3 x 2^-8 < 2^-6
UPDATE_TOL = 2.0 ** -6
#: route on exact logits: the packages' float32 ``exp`` differ by up to 2
#: ULP (XLA's CPU polynomial, PyTorch's SLEEF), and the renormalisation's
#: sum and division add one each (measured: <= 4 over 40 draws)
ROUTE_ULP = 4
AUX_ULP = 4       # measured <= 2: sums over the tokens in another order
ROUTE_RTOL = 2e-6
#: moe_dense in bf16: a fraction of max|want| (two bf16 ulps, 2^-7)
BF16_TOL = 2.0 ** -7
ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")


def _cfgs(arch, **kw):
    return jget_config(arch).reduced(**kw), tget_config(arch).reduced(**kw)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _ulp(got, want) -> int:
    return int(tref.ulp_distance(
        got.detach().reshape(-1), torch.from_numpy(
            np.array(want, np.float32).reshape(-1))).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _is_def(v):
    return isinstance(v, jmodule.ParamDef)


def _weights(cfg, seed=1):
    """(JAX params, {path: float32 array}) for ``cfg``."""
    defs = jT.param_defs(cfg)
    leaves = jax.tree_util.tree_flatten_with_path(defs, is_leaf=_is_def)[0]
    rng = np.random.default_rng(seed)
    flat = {}
    for path, d in leaves:
        k = ".".join(str(p.key) for p in path)
        leaf = k.split(".")[-1]
        if d.init == "zeros":
            v = rng.standard_normal(d.shape) * 0.3
        elif d.init == "embed":
            v = rng.standard_normal(d.shape) * d.scale
        else:
            if leaf in ("wq", "wk", "wv") and ".attn." in k:
                fan_in = d.shape[1]                      # d_model
            elif leaf == "wo" and ".attn." in k:
                fan_in = d.shape[1] * d.shape[2]         # heads x head_dim
            else:
                fan_in = d.shape[-2]
            v = rng.standard_normal(d.shape) * d.scale / fan_in ** 0.5
        flat[k] = v.astype(np.float32)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(defs, is_leaf=_is_def),
        [jnp.asarray(flat[".".join(str(p.key) for p in path)])
         for path, _ in leaves])
    return jp, flat


@pytest.fixture(scope="module")
def models():
    """{arch: (jax cfg, port cfg, jax params, port params, flat)}."""
    out = {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp, flat = _weights(jc)
        out[arch] = (jc, tc, jp, convert.lm_params_from_numpy(flat, tc, "cpu"),
                     flat)
    return out


def _flat_jax(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------- routing

def _router_inputs(seed, t=96, d=64, e=8, dyadic=True):
    """(x, router) whose logits are exact in float32 in any order of the
    contraction's sums (multiples of 1/512 far below 2^15) when
    ``dyadic``, else standard normal draws."""
    rng = np.random.default_rng(seed)
    if dyadic:
        return ((rng.integers(-16, 17, (t, d)) / 8).astype(np.float32),
                (rng.integers(-8, 9, (d, e)) / 64).astype(np.float32))
    return (rng.standard_normal((t, d)).astype(np.float32),
            (rng.standard_normal((d, e)) / 8).astype(np.float32))


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("e, k", [(4, 2), (8, 2), (16, 8), (64, 8)])
def test_route_matches_reference(e, k, dyadic):
    """Router logits, softmax, top-k, renormalised weights and the two
    aux losses, against the reference under ``jit`` (as the stack runs
    it).  On exact logits, ``top_w`` within ``ROUTE_ULP``, the aux losses
    within ``AUX_ULP``; on float logits (last bits apart: the
    contraction's sums in another order) within ``ROUTE_RTOL``; the
    expert choices bitwise either way."""
    x, w = _router_inputs(e, e=e, dyadic=dyadic)
    jc, tc = _cfgs("kimi-k2-1t-a32b", n_experts=e, top_k=k)
    want_idx, want_w, want_aux = jax.jit(
        lambda w, x: jmoe.route(w, x, jc))(w, x)
    idx, tw, aux = tmoe.route(_t(w), _t(x), tc)
    assert idx.shape == (96, k) and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    if dyadic:
        assert _ulp(tw, want_w) <= ROUTE_ULP
        for name in ("lb_loss", "z_loss"):
            assert _ulp(aux[name], want_aux[name]) <= AUX_ULP, name
    else:
        np.testing.assert_allclose(tw.numpy(), np.asarray(want_w),
                                   rtol=ROUTE_RTOL)
        for name in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(float(aux[name]),
                                       float(want_aux[name]), rtol=ROUTE_RTOL)


def test_route_breaks_ties_to_the_lower_index():
    """An all-zero token ties every expert (the reference picks 0..k-1);
    two equal router columns tie two experts in every token (the lower
    index first).  ``torch.topk`` promises neither order."""
    x, w = _router_inputs(3, t=40, e=8)
    x[:5] = 0.0
    w[:, 5] = w[:, 2]
    jc, tc = _cfgs("kimi-k2-1t-a32b", n_experts=8, top_k=4)
    want_idx, want_w, want_aux = jax.jit(
        lambda w, x: jmoe.route(w, x, jc))(w, x)
    idx, tw, aux = tmoe.route(_t(w), _t(x), tc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx[:5].numpy(), [[0, 1, 2, 3]] * 5)
    both = (idx == 2).any(-1) & (idx == 5).any(-1)
    assert both.any()
    pos2 = (idx == 2).int().argmax(-1)
    pos5 = (idx == 5).int().argmax(-1)
    assert bool((pos2[both] < pos5[both]).all())
    assert _ulp(tw, want_w) <= ROUTE_ULP
    for name in ("lb_loss", "z_loss"):
        assert _ulp(aux[name], want_aux[name]) <= AUX_ULP, name


def test_capacity_matches_reference():
    for arch in ARCHS:
        for e, k, cf in ((8, 2, 1.25), (384, 8, 1.0), (4, 2, 2.0)):
            jc = dataclasses.replace(jget_config(arch), n_experts=e, top_k=k,
                                     capacity_factor=cf)
            tc = dataclasses.replace(tget_config(arch), n_experts=e, top_k=k,
                                     capacity_factor=cf)
            for n in (1, 7, 8, 9, 64, 100, 1000, 16384):
                for parts in (1, 4, 16):
                    assert (tmoe.capacity(n, tc, parts)
                            == jmoe.capacity(n, jc, parts))


# ------------------------------------------------------------ moe_dense

@pytest.mark.parametrize("arch", ARCHS)   # kimi: with the shared expert
def test_moe_dense_matches_reference(models, arch):
    jc, tc, jp, tp, _ = models[arch]
    jlp = jax.tree_util.tree_map(lambda p: p[0], jp["layers"]["moe"])
    tlp = tT.layer_params(tp, 0)["moe"]
    assert ("shared" in tlp) == (arch == "kimi-k2-1t-a32b")
    x = np.random.default_rng(2).standard_normal((2, 23, 64)).astype(
        np.float32)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_dense(p, x, jc))(jlp, x)
    got, aux = tmoe.moe_dense(tlp, _t(x), tc)
    _close(got, want, MOE_TOL)
    for name in ("lb_loss", "z_loss"):
        assert _ulp(aux[name], want_aux[name]) <= 4, name
    # every expert is used, and both expert choices of a token matter
    idx, _, _ = tmoe.route(tlp["router"], _t(x).reshape(-1, 64), tc)
    assert set(idx.flatten().tolist()) == set(range(tc.n_experts))


def test_moe_dense_bf16_matches_reference(models):
    """bf16 tokens, kimi's layer (shared expert included): the experts'
    gated MLPs in bf16, the accumulator float32, one cast at the end."""
    jc, tc, jp, tp, _ = models["kimi-k2-1t-a32b"]
    jlp = jax.tree_util.tree_map(lambda p: p[1], jp["layers"]["moe"])
    tlp = tT.layer_params(tp, 1)["moe"]
    x = np.random.default_rng(3).standard_normal((2, 17, 64)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = jax.jit(lambda p, x: jmoe.moe_dense(p, x, jc))(jlp, xb)
    got, _ = tmoe.moe_dense(tlp, _t(x).to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


# ------------------------------------------------------------ the stack

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_both_reference_modes(models, arch):
    """``forward`` logits and aux (the mean over the expert layers of each
    loss) and ``loss_fn``'s total and metrics, against the reference
    scanned and unrolled (unrolled with ``remat`` off, which changes no
    value: the reference's unrolled form cannot run an expert layer under
    its remat, ``test_reference_unrolled_moe_forward_fails_under_remat``)."""
    jc0, tc, jp, tp, _ = models[arch]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 40)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 40)).astype(np.int32)
    with torch.no_grad():
        got, aux = tT.forward(tp, _t(tokens), tc)
        loss, m = tT.loss_fn(tp, _t(tokens), _t(labels), tc)
    assert float(aux["lb_loss"]) > 0.9 and float(aux["z_loss"]) > 0
    for unroll in (False, True):
        jc = dataclasses.replace(jc0, remat=not unroll)
        want, want_aux, want_loss, want_m = jax.jit(lambda p, t, l: (
            *jT.forward(p, t, jc, unroll=unroll),
            *jT.loss_fn(p, t, l, jc, unroll=unroll)))(jp, tokens, labels)
        _close(got, want)
        for name in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                       rtol=MOE_TOL)
            np.testing.assert_allclose(float(m[name]), float(want_m[name]),
                                       rtol=MOE_TOL)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
        np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                                   rtol=TOL)


def test_reference_unrolled_moe_forward_fails_under_remat(models):
    """A fault of the reference (ROADMAP.md, queue 3): its unrolled
    ``forward`` wraps each layer in ``jax.checkpoint`` and appends the
    expert layer's aux losses to a list outside it, so the traced values
    escape and every MoE config (``remat=True`` in all of them) fails
    there; its scanned form returns them.  The port's remat returns them
    from the checkpointed layer: its gradients under remat equal its
    gradients without."""
    jc, tc, jp, tp, _ = models["grok-1-314b"]
    tokens = np.zeros((1, 8), np.int32)
    assert jc.remat
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jT.forward(jp, tokens, jc, unroll=True)
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(tc, remat=remat)
        p = {k: v.clone().requires_grad_() for k, v in
             tmodule.flatten(tp).items()}
        total, m = tT.loss_fn(tmodule.unflatten(p), _t(tokens), _t(tokens), c)
        total.backward()
        grads.append({k: v.grad for k, v in p.items()})
        assert float(m["lb_loss"].detach()) > 0
    assert grads[0]["layers.moe.router"].abs().max() > 0
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(models, arch):
    """``loss_fn``'s total (the cross-entropy plus ``lb_coef`` x
    ``lb_loss`` plus ``z_coef`` x ``z_loss``) differentiated in the port
    against ``jax.grad`` of the reference's scanned ``loss_fn`` (under its
    remat, as the configs train): every leaf within rtol = GRAD_TOL, atol
    = GRAD_TOL x max|leaf|, the shared expert's (kimi) included.  Each
    aux loss's own gradient at the router is held the same way, and each
    of the router gradient's three terms (the cross-entropy's, through
    the renormalised ``top_w``, and the two aux losses' times their
    coefficients) is over 10 times the band, so a detached ``top_w``, a
    dropped aux term or one of the wrong sign fails."""
    jc, tc, jp, _, flat = models[arch]
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (2, 37)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 37)).astype(np.int32)
    coef = {"total": 1.0, "lb_loss": 0.01, "z_loss": 1e-3}   # loss_fn's

    def parts(p):
        total, m = jT.loss_fn(p, tokens, labels, jc)
        return jnp.stack([total, m["lb_loss"], m["z_loss"]])

    want_v = jax.jit(parts)(jp)
    want = jax.jit(jax.jacrev(parts))(jp)     # each leaf: (3, *shape)
    p = {k: _t(v).clone().requires_grad_() for k, v in flat.items()}
    total, m = tT.loss_fn(tmodule.unflatten(p), _t(tokens), _t(labels), tc)
    router = {}
    for i, part in enumerate(coef):
        got_v = total if part == "total" else m[part]
        np.testing.assert_allclose(float(got_v.detach()), float(want_v[i]),
                                   rtol=TOL)
        got = dict(zip(p, torch.autograd.grad(got_v, list(p.values()),
                                              retain_graph=True,
                                              allow_unused=True)))
        w = {k: np.asarray(v[i]) for k, v in _flat_jax(want).items()}
        for k in (w if part == "total" else ["layers.moe.router"]):
            g = got[k].numpy() if got[k] is not None else np.zeros_like(w[k])
            np.testing.assert_allclose(
                g, w[k], rtol=GRAD_TOL,
                atol=GRAD_TOL * float(np.abs(w[k]).max()), err_msg=(part, k))
        router[part] = coef[part] * w["layers.moe.router"]
        if part == "total" and "layers.moe.shared.wo" in w:
            assert np.abs(w["layers.moe.shared.wo"]).max() > 0
    band = GRAD_TOL * np.abs(router["total"]).max()
    cross_entropy = router["total"] - router["lb_loss"] - router["z_loss"]
    for term in (cross_entropy, router["lb_loss"], router["z_loss"]):
        assert np.abs(term).max() > 10 * band


def test_prefill_and_decode_match_reference(models):
    """kimi: a prefill of 30 tokens and 8 decode steps; the expert layers'
    aux losses are dropped there, as in the reference."""
    jc, tc, jp, tp, _ = models["kimi-k2-1t-a32b"]
    tokens = np.random.default_rng(6).integers(0, 256, (2, 38)).astype(
        np.int32)
    jl, jcache, _ = jax.jit(lambda p, t: jT.prefill(p, t, jc, max_len=40))(
        jp, tokens[:, :30])
    jdec = jax.jit(lambda p, t, c, pos: jT.decode_step(p, t, c, pos, jc))
    with torch.inference_mode():
        tl, tcache, tpos = tT.prefill(tp, _t(tokens[:, :30]), tc, 40)
        assert tpos == 30
        _close(tl, jl)
        for i in range(30, 38):
            jl, jcache = jdec(jp, tokens[:, i:i + 1], jcache, jnp.int32(i))
            tl, tcache = tT.decode_step(tp, _t(tokens[:, i:i + 1]), tcache,
                                        i, tc)
            _close(tl, jl)
    for t, j in zip(convert.decode_caches_to_numpy(tcache),
                    [_flat_jax(c) for c in jcache]):
        assert set(t) == set(j) == {"k", "v", "pos"}
        np.testing.assert_array_equal(t["pos"], j["pos"])
        _close(t["k"], j["k"])
        _close(t["v"], j["v"])


def test_serve_engine_matches_reference(models):
    """kimi: three prompts of unequal length, left-padded: greedy tokens
    equal the JAX engine's."""
    jc, tc, jp, tp, _ = models["kimi-k2-1t-a32b"]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (30, 17, 25)]
    je = jengine.ServeEngine(jc, jp, max_len=48)
    te = tengine.ServeEngine(tc, tp, max_len=48, device="cpu")
    jres = je.serve([jengine.Request(p, max_new_tokens=6) for p in prompts])
    tres = te.serve([tengine.Request(p, max_new_tokens=6) for p in prompts])
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_prefill, t.n_decoded) == (j.n_prefill, j.n_decoded)


def test_trainer_step_matches_reference(models):
    """kimi's ``Trainer`` as its config gives it (Adafactor, the bf16
    gradient accumulator) at 2 microbatches, one step from the same
    weights on the same batch in both packages: metrics within 1e-5
    relative (the loss within the stack's band), and each cell's update
    (new less old parameter) against the reference's within
    ``UPDATE_TOL`` x max|update of its leaf| (measured: 2.8e-3 at most,
    in ``layers.moe.we_up``)."""
    jc, tc, jp, tp, flat = models["kimi-k2-1t-a32b"]
    jc = dataclasses.replace(jc, n_microbatches=2)
    tc = dataclasses.replace(tc, n_microbatches=2)
    assert (tc.optimizer, tc.accum_dtype) == ("adafactor", "bfloat16")
    lr = 1e-3
    jtr = jloop.Trainer(jc, jloop.TrainerConfig(lr=lr, warmup_steps=0,
                                                decay_steps=100))
    ttr = tloop.Trainer(tc, tloop.TrainerConfig(lr=lr, warmup_steps=0,
                                                decay_steps=100),
                        device="cpu")
    jtr.params, jtr.opt_state = jp, jtr.opt.init(jp)
    tp = convert.lm_params_from_numpy(flat, tc, "cpu")
    ttr.params, ttr.opt_state = tp, ttr.opt.init(tp)
    jtr.step = ttr.step = 3       # the schedule's lr is 0 at step 0
    from repro.events.pipeline import TokenPipeline as JTokenPipeline
    jh = jtr.train(JTokenPipeline(256, 4, 24, seed=2), 1)["history"][0]
    th = ttr.train(TokenPipeline(256, 4, 24, seed=2), 1)["history"][0]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=TOL)
    for name in ("lb_loss", "z_loss"):
        assert th[name] > 0
        np.testing.assert_allclose(th[name], jh[name], rtol=MOE_TOL)
    got = tmodule.flatten(ttr.params)
    moved = 0
    for k, w in _flat_jax(jtr.params).items():
        want_u = w - flat[k]
        got_u = got[k].numpy() - flat[k]
        scale = float(np.abs(want_u).max())
        assert scale > 0, k
        err = float(np.abs(got_u - want_u).max())
        assert err <= UPDATE_TOL * scale, (k, err / scale)
        moved += int((got_u != 0).sum())
    assert moved > 0.9 * sum(v.size for v in flat.values())


# ----------------------------------------------------- configs and plumbing

def test_config_registry_matches_reference():
    """Each MoE config field for field, its parameter count at full size
    (kimi-k2: ~1.03 T, grok-1: ~316 B) and at ``reduced()``."""
    for arch in ARCHS:
        jc, tc = jget_config(arch), tget_config(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        for c, j in ((tc, jc), _cfgs(arch)[::-1]):
            assert (tmodule.count_params(tT.param_defs(c))
                    == jmodule.count_params(jT.param_defs(j)))
            assert tT.layer_windows(c) == jT.layer_windows(j)
    assert round(tget_config("grok-1-314b").n_params() / 1e9) == 316
    kimi = tT.param_defs(tget_config("kimi-k2-1t-a32b"))
    assert kimi["layers"]["moe"]["we_gate"].shape == (61, 384, 7168, 2048)
    assert kimi["layers"]["moe"]["shared"]["wo"].shape == (61, 2048, 7168)


def test_convert_round_trips(models):
    """The expert leaves (router, stacked experts, the shared expert)
    cross both ways bitwise; a missing expert leaf raises."""
    _, tc, _, tp, flat = models["kimi-k2-1t-a32b"]
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(flat)
    assert {"layers.moe.router", "layers.moe.we_down",
            "layers.moe.shared.wi_gate"} <= set(back)
    for k in flat:
        np.testing.assert_array_equal(back[k].view(np.int32),
                                      flat[k].view(np.int32))
    bad = dict(flat)
    bad.pop("layers.moe.we_up")
    with pytest.raises(KeyError, match="we_up"):
        convert.lm_params_from_numpy(bad, tc, "cpu")


def test_launch_tokens_matches_reference(capsys):
    """``tokens --arch grok-1-314b --reduced`` on the CPU prints the JAX
    CLI's request lines: weights from ``PRNGKey(0)`` in both packages."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    serve.main(["tokens", "--arch", "grok-1-314b", "--reduced", "--requests",
                "3", "--new-tokens", "5", "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req ")]
    jserve.run_tokens(argparse.Namespace(arch="grok-1-314b", reduced=True,
                                         requests=3, new_tokens=5,
                                         max_len=128))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    assert len(got) == 3 and got == want
