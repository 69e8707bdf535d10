"""The repro_torch Mamba-2 serving path vs the JAX package, on the CPU.

The reduced ``mamba2-2.7b`` (2 layers, d_model 64, 8 SSD heads x 16,
state 16, chunk 16, vocab 256, float32) in both packages.  Inputs and
weights are drawn with numpy from a seed, the weights in the shapes and
scales of the reference's initialisers, and cross into the port through
``repro_torch.convert``; ``init_params`` itself is held against the
reference's on the same ``PRNGKey`` (keys bitwise, every leaf within
``prng.normal``'s 4 ULP).  Every zero- or one-initialised leaf is noised
so that each of them matters; ``dt_bias`` lies in [-6, -2], so that dt = softplus(.)
spans Mamba-2's own init range of ~0.001-0.1 and the state remembers
tens of steps.

Band: rtol = atol = 2e-5 for ``decay_scan``, the reference's own bar
(``tests/test_kernels.py``); everywhere else rtol = 2e-5 and
atol = 2e-5 x max(1, max|want|), the absolute part scaled to the tensor:
both sides are float32 and differ only in the order of sums inside
contractions and cumsums, and an element near zero is a cancellation of
terms of the tensor's size.  Measured: at most ~2e-6 on logits of
magnitude ~4, ~1e-5 on SSD outputs of magnitude ~40.  Tokens, argmaxes
of those logits, must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import module as jmodule
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import prng as tprng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import module as tmodule
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine

jax.config.update("jax_platforms", "cpu")

TOL = 2e-5
JCFG = jget_config("mamba2-2.7b").reduced()
TCFG = tget_config("mamba2-2.7b").reduced()
_NOISED = {"ln1", "ln_f", "norm", "a_log", "dt_bias", "d_skip", "conv_x_b",
           "conv_b_b", "conv_c_b"}


def _close(got, want, scaled=True):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0))) if scaled else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * scale)


def _flat_jax(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflat_jax(defs, flat):
    is_def = lambda v: isinstance(v, jmodule.ParamDef)
    paths = jax.tree_util.tree_flatten_with_path(defs, is_leaf=is_def)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(defs, is_leaf=is_def),
        [jnp.asarray(flat[".".join(str(k.key) for k in p)]) for p, _ in paths])


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params, {path: array}) of one seeded weight set,
    drawn with numpy in the shapes and scales of the reference's
    initialisers, then noised where those are constant."""
    defs = jT.param_defs(JCFG)
    rng = np.random.default_rng(1)
    flat = {}
    for path, d in jax.tree_util.tree_flatten_with_path(
            defs, is_leaf=lambda v: isinstance(v, jmodule.ParamDef))[0]:
        k = ".".join(str(p.key) for p in path)
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
    return (_unflat_jax(defs, flat),
            convert.lm_params_from_numpy(flat, TCFG, "cpu"), flat)


def _layer0(weights):
    jp, tp, _ = weights
    return (jax.tree_util.tree_map(lambda p: p[0], jp["layers"]["ssm"]),
            tT.layer_params(tp, 0)["ssm"])


# ---------------------------------------------------------------- decay_scan

@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("btc", [(1, 1, 1), (2, 200, 70), (3, 128, 128),
                                 (1, 513, 5), (4, 64, 257)])
def test_decay_scan_matches_reference(btc, with_s0):
    """The port's plain decay_scan vs the JAX Pallas kernel (interpret
    mode) and the JAX oracle, over the reference's kernel-test shapes."""
    b, t, c = btc
    rng = np.random.default_rng(b * 100000 + t * 100 + c)
    a = np.exp(-rng.uniform(0.0, 0.3, btc)).astype(np.float32)
    x = rng.standard_normal(btc).astype(np.float32)
    s0 = rng.standard_normal((b, c)).astype(np.float32) if with_s0 else None
    st, fin = tops.decay_scan(torch.from_numpy(a), torch.from_numpy(x),
                              None if s0 is None else torch.from_numpy(s0))
    assert st.dtype == fin.dtype == torch.float32
    assert st.shape == btc and fin.shape == (b, c)
    js0 = None if s0 is None else jnp.asarray(s0)
    for want in (jops.decay_scan(a, x, js0, backend="interpret"),
                 jref.decay_scan_ref(jnp.asarray(a), jnp.asarray(x), js0)):
        _close(st, want[0], scaled=False)
        _close(fin, want[1], scaled=False)


# ----------------------------------------------------------- SSD block parts

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """T = 37 pads to three chunks of 16; with and without a carried-in
    state."""
    rng = np.random.default_rng(3)
    b, t, h, p, n = 2, 37, 8, 16, 16
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    a_log = -rng.uniform(0.0, 0.5, (b, t, h)).astype(np.float32)
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_state else None)
    y, fin = tssm.ssd_chunked(*map(torch.from_numpy, (x, a_log, bb, cc)), 16,
                              None if s0 is None else torch.from_numpy(s0))
    jy, jfin = jssm.ssd_chunked(*map(jnp.asarray, (x, a_log, bb, cc)), 16,
                                None if s0 is None else jnp.asarray(s0))
    assert y.shape == (b, t, h, p) and fin.shape == (b, h, p, n)
    _close(y, jy)
    _close(fin, jfin)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssm_block_matches_reference(weights, use_pallas):
    """The full-sequence block, its conv rings and final state.  The JAX
    side takes the oracle, and once the Pallas kernel in interpret mode."""
    jlp, tlp = _layer0(weights)
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(
        np.float32)
    y, (conv, st) = tssm.ssm_block(tlp, torch.from_numpy(x), TCFG)
    jy, (jconv, jst) = jssm.ssm_block(jlp, jnp.asarray(x), JCFG,
                                      use_pallas=use_pallas)
    _close(y, jy)
    _close(st, jst)
    for k in ("x", "b", "c"):
        _close(conv[k], jconv[k])


def test_ssm_decode_step_matches_reference(weights):
    jlp, tlp = _layer0(weights)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    conv = {"x": rng.standard_normal((3, 3, 128)).astype(np.float32),
            "b": rng.standard_normal((3, 3, 16)).astype(np.float32),
            "c": rng.standard_normal((3, 3, 16)).astype(np.float32)}
    st = rng.standard_normal((3, 8, 16, 16)).astype(np.float32)
    y, (nconv, nst) = tssm.ssm_decode_step(
        tlp, torch.from_numpy(x), TCFG,
        {k: torch.from_numpy(v) for k, v in conv.items()},
        torch.from_numpy(st))
    jy, (jconv, jst) = jssm.ssm_decode_step(
        jlp, jnp.asarray(x), JCFG, {k: jnp.asarray(v) for k, v in conv.items()},
        jnp.asarray(st))
    _close(y, jy)
    _close(nst, jst)
    for k in conv:
        _close(nconv[k], jconv[k])


def test_rms_norm_and_softplus_match_reference():
    from repro.models import layers as jlayers

    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    # torch's F.softplus returns x itself above 20; jax.nn.softplus does not
    v = np.array([-80, -30, -1, 0, 0.5, 19.9, 20.5, 25, 80], np.float32)
    _close(tssm.softplus(torch.from_numpy(v)), jax.nn.softplus(v))


# ------------------------------------------------------- stack and engine

def test_forward_and_chunked_vs_recurrent(weights):
    """``forward`` logits vs the reference's; inside the port, prefill of
    the whole prompt == prefill of all but the last token, then one
    ``decode_step``, in logits and in every layer's state."""
    jp, tp, _ = weights
    tokens = np.random.default_rng(7).integers(0, 256, (2, 35)).astype(
        np.int32)
    logits, _ = tT.forward(tp, torch.from_numpy(tokens), TCFG)
    jlogits, _ = jax.jit(lambda p, t: jT.forward(p, t, JCFG, unroll=True))(
        jp, jnp.asarray(tokens))
    _close(logits, jlogits)
    whole, wc, _ = tT.prefill(tp, torch.from_numpy(tokens), TCFG, 64,
                              last_logits_only=True)
    _close(whole, logits[:, -1:])
    _, caches, pos = tT.prefill(tp, torch.from_numpy(tokens[:, :-1]), TCFG,
                                64)
    step, sc = tT.decode_step(tp, torch.from_numpy(tokens[:, -1:]), caches,
                              pos, TCFG)
    _close(step, whole)
    for a, b in zip(sc, wc):
        _close(a["ssm"]["state"], b["ssm"]["state"])


def test_serve_engine_matches_reference(weights):
    """Three prompts of unequal length, past one chunk, left-padded with
    token 0: greedy tokens equal the JAX engine's; the prefill's last
    logits and every layer's state and conv ring sit in the band.  The
    pad tokens run through the recurrence as in the reference: a short
    prompt's state differs from that of the same prompt served alone."""
    jp, tp, _ = weights
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 23, 57)]
    je = jengine.ServeEngine(JCFG, jp, max_len=128)
    te = tengine.ServeEngine(TCFG, tp, max_len=128, device="cpu")
    jres = je.serve([jengine.Request(p, max_new_tokens=6) for p in prompts])
    tres = te.serve([tengine.Request(p, max_new_tokens=6) for p in prompts])
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_prefill, t.n_decoded) == (j.n_prefill, j.n_decoded)

    padded = np.zeros((3, 57), np.int32)
    for i, p in enumerate(prompts):
        padded[i, 57 - len(p):] = p
    jl, jc, jpos = je._prefill(jp, jnp.asarray(padded))
    with torch.inference_mode():
        tl, tc, tpos = te._prefill(tp, torch.from_numpy(padded))
    assert tpos == jpos == 57 and tl.shape == (3, 1, 256)
    _close(tl, np.asarray(jl)[:, -1:])
    jcn = [_flat_jax(c) for c in jc]
    for t, j in zip(convert.decode_caches_to_numpy(tc), jcn):
        assert set(t) == set(j)
        for k in t:
            _close(t[k], j[k])

    # the port's padded states sit in the band of the reference's, and the
    # pad tokens moved them: the short prompt served alone ends elsewhere
    _, alone, _ = tT.prefill(tp, torch.from_numpy(prompts[1][None]), TCFG, 128)
    for t, a in zip(tc, alone):
        gap = (t["ssm"]["state"][1] - a["ssm"]["state"][0]).abs().max()
        assert float(gap) > 1e-3


# ----------------------------------------------------- configs and plumbing

def test_config_registry_matches_reference():
    import dataclasses

    jc, tc = jget_config("mamba2-2.7b"), tget_config("mamba2-2.7b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.n_params() == jc.n_params()
    assert tc.activation_dtype == torch.bfloat16
    assert TCFG.activation_dtype == torch.float32
    for c, jcfg in ((tc, jc), (TCFG, JCFG)):
        assert (tmodule.count_params(tT.param_defs(c))
                == jmodule.count_params(jT.param_defs(jcfg)))
        assert tT.padded_vocab(c) == jT.padded_vocab(jcfg)
    assert tT.padded_vocab(tc) == 50432
    # every entry of the reference's registry resolves, equal to the
    # reference's field for field, the time-surface array's ISCConfig
    # included (left out of ARCH_NAMES in both); a mesh that is not a
    # ProcessMesh raises (meshes are held in test_torch_fsdp.py)
    for name in ("kimi-k2-1t-a32b", "grok-1-314b", "musicgen-large",
                 "internvl2-26b", "hymba-1.5b"):
        c, jcfg = tget_config(name), jget_config(name)
        assert dataclasses.asdict(c) == dataclasses.asdict(jcfg)
        assert (tmodule.count_params(tT.param_defs(c))
                == jmodule.count_params(jT.param_defs(jcfg)))
    from repro.configs import ARCH_NAMES as J_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES as T_ARCH_NAMES

    assert (dataclasses.asdict(tget_config("isc-qvga"))
            == dataclasses.asdict(jget_config("isc-qvga")))
    assert T_ARCH_NAMES == J_ARCH_NAMES and "isc-qvga" not in T_ARCH_NAMES
    with pytest.raises(KeyError):
        tget_config("no-such-arch")
    with pytest.raises(TypeError, match="ProcessMesh"):
        tT.forward({}, torch.zeros((1, 4), dtype=torch.int32),
                   tget_config("grok-1-314b").reduced(), mesh=object())


def test_lm_convert_round_trips(weights):
    _, tp, flat = weights
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].view(np.int32),
                                      flat[k].view(np.int32))
    caches = tT.init_decode_caches(TCFG, 2, 64, device="cpu")
    caches[1]["ssm"]["state"].normal_()
    again = convert.decode_caches_from_numpy(
        convert.decode_caches_to_numpy(caches), TCFG, "cpu")
    for a, b in zip(caches, again):
        for k, v in tmodule.flatten(a).items():
            assert torch.equal(tmodule.flatten(b)[k], v)
    bad = dict(flat)
    bad.pop("ln_f")
    with pytest.raises(KeyError, match="ln_f"):
        convert.lm_params_from_numpy(bad, TCFG, "cpu")


def test_init_params_initialisers():
    """Zeros, ones, fan-in normal and scaled embed, as the reference's
    initialisers; the same key gives the same weights."""
    defs = tT.param_defs(TCFG)
    p = tmodule.init_params(defs, tprng.PRNGKey(0), "cpu")
    q = tmodule.init_params(defs, tprng.PRNGKey(0), "cpu")
    flat, fdefs = tmodule.flatten(p), tmodule.flatten(defs)
    for k, d in fdefs.items():
        assert flat[k].shape == d.shape and flat[k].dtype == torch.float32
        assert torch.equal(flat[k], tmodule.flatten(q)[k])
    assert not flat["ln_f"].any() and bool((flat["layers.ssm.d_skip"] == 1).all())
    assert abs(float(flat["embed"].std()) - 0.02) < 0.002
    assert abs(float(flat["layers.ssm.x_proj"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(flat["layers.ssm.conv_x_w"].std()) - 0.25) < 0.03
    half = tmodule.cast_floating(p, torch.bfloat16)
    assert half["layers"]["ssm"]["z_proj"].dtype == torch.bfloat16


NORMAL_ULP = 4   # prng.normal's band (tests/test_torch_fidelity.py)


@pytest.mark.parametrize("seed", [0, 11])
def test_init_params_matches_reference(seed, monkeypatch):
    """On the same ``PRNGKey`` the port splits the reference's per-leaf
    keys bitwise, in the reference's leaf order, and draws every leaf
    within 4 ULP of the reference's ``init_params``; drawn in slices of
    fewer elements than the largest leaf, the weights are the same."""
    jdefs, tdefs = jT.param_defs(JCFG), tT.param_defs(TCFG)
    want = _flat_jax(jmodule.init_params(jdefs, jax.random.PRNGKey(seed)))
    got = tmodule.flatten(tmodule.init_params(tdefs, tprng.PRNGKey(seed),
                                              "cpu"))
    assert list(got) == list(want)
    jkeys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed),
                                                 len(want)))
    np.testing.assert_array_equal(
        tprng.split(tprng.PRNGKey(seed), len(got)).numpy(),
        np.asarray(jkeys).astype(np.int64))
    for k, v in got.items():
        w = want[k]
        assert v.shape == w.shape and v.numpy().dtype == w.dtype, k
        ulp = tref.ulp_distance(v, torch.from_numpy(np.array(w)))
        assert int(ulp.max()) <= NORMAL_ULP, (k, int(ulp.max()))
    monkeypatch.setattr(tmodule, "_DRAW_SLICE", 1000)
    sliced = tmodule.flatten(tmodule.init_params(tdefs, tprng.PRNGKey(seed),
                                                 "cpu"))
    assert all(torch.equal(sliced[k], v) for k, v in got.items())


def test_launch_tokens_matches_reference(capsys):
    """The ``tokens`` CLI on the reduced config with ``--device cpu``
    generates the reference CLI's tokens (both draw their weights from
    ``PRNGKey(0)``)."""
    import argparse

    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    argv = ["--arch", "mamba2-2.7b", "--reduced", "--requests", "3",
            "--new-tokens", "5"]
    serve.main(["tokens", *argv, "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req ")]
    jserve.run_tokens(argparse.Namespace(arch="mamba2-2.7b", reduced=True,
                                         requests=3, new_tokens=5,
                                         max_len=128))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    assert len(got) == 3 and got == want


def test_launch_tokens_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    serve.main(["tokens", "--arch", "mamba2-2.7b", "--reduced",
                "--requests", "2", "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "6 tokens in" in out and "CPU" in out
    serve.main(["tokens", "--arch", "hymba-1.5b", "--reduced",
                "--requests", "2", "--new-tokens", "3", "--device", "cpu"])
    assert capsys.readouterr().out.count("req ") == 2
    # isc-qvga is no LM: it fails as the reference's run_tokens fails on it
    # (ISCConfig has no reduced())
    import sys

    from repro.launch import serve as jserve

    argv = ["tokens", "--arch", "isc-qvga", "--reduced"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(Exception) as jexc:
        jserve.main()
    with pytest.raises(jexc.type, match="reduced"):
        serve.main(argv + ["--device", "cpu"])
