"""The repro_torch hybrid family (hymba) vs the JAX package, on the CPU.

``hymba-1.5b`` at ``reduced()`` in both packages: 2 layers (layer 0
global, layer 1 local with a window of 32), d_model 64, 4 query heads and
1 KV head of 16, a Mamba-2 head of 4 SSD heads x 16 with state 16 and
chunk 16 beside the attention in every layer, d_ff 128, vocab 256,
float32.  Weights and inputs are drawn with numpy from a seed and cross
into the port through ``repro_torch.convert``: the leaves the reference
initialises to constants are noised, ``dt_bias`` lies in [-6, -2] (as
``tests/test_torch_lm.py`` draws it) and the attention projections are
drawn at their true fan-in (``tests/test_torch_dense.py`` says why).

Band, as the LM tests': rtol 2e-5 and atol 2e-5 x max(1, max|want|) on
logits, K/V, conv rings and SSM states (float32 on both sides, sums in
another order); positions bitwise, greedy tokens equal; gradients within
rtol 1e-4, atol 1e-4 x max|leaf| (``tests/test_torch_train.py``'s).
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
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.models import module as tmodule
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine

jax.config.update("jax_platforms", "cpu")

TOL = 2e-5
GRAD_TOL = 1e-4
ARCH = "hymba-1.5b"
JCFG = jget_config(ARCH).reduced()
TCFG = tget_config(ARCH).reduced()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _is_def(v):
    return isinstance(v, jmodule.ParamDef)


def _flat_jax(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, {path: float32 array})."""
    defs = jT.param_defs(JCFG)
    leaves = jax.tree_util.tree_flatten_with_path(defs, is_leaf=_is_def)[0]
    rng = np.random.default_rng(1)
    flat = {}
    for path, d in leaves:
        k = ".".join(str(p.key) for p in path)
        leaf = k.split(".")[-1]
        if leaf == "dt_bias":
            v = rng.uniform(-6.0, -2.0, d.shape)
        elif d.init in ("zeros", "ones") or leaf in ("a_log", "d_skip"):
            v = rng.standard_normal(d.shape) * 0.3 + (d.init == "ones")
        elif d.init == "embed":
            v = rng.standard_normal(d.shape) * d.scale
        else:
            if leaf in ("wq", "wk", "wv") and ".attn." in k:
                fan_in = d.shape[1]
            elif leaf == "wo" and ".attn." in k:
                fan_in = d.shape[1] * d.shape[2]
            else:
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            v = rng.standard_normal(d.shape) * d.scale / fan_in ** 0.5
        flat[k] = v.astype(np.float32)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(defs, is_leaf=_is_def),
        [jnp.asarray(flat[".".join(str(p.key) for p in path)])
         for path, _ in leaves])
    return jp, convert.lm_params_from_numpy(flat, TCFG, "cpu"), flat


def _caches_equal(tc, jc):
    for t, j in zip(convert.decode_caches_to_numpy(tc),
                    [_flat_jax(c) for c in jc]):
        assert set(t) == set(j) == {"k", "v", "pos", "ssm.conv.x",
                                    "ssm.conv.b", "ssm.conv.c", "ssm.state"}
        for k in t:
            if k == "pos":
                np.testing.assert_array_equal(t[k], j[k])
            else:
                _close(t[k], j[k])


def test_config_and_layer_layout():
    """The config field for field and its parameter count at full size
    (1.394 B) and at ``reduced()``; every layer holds both mixers and
    their output norms; layers 0, 15 and 31 are global."""
    jc, tc = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert tc.n_params() == jc.n_params()
    for c, j in ((tc, jc), (TCFG, JCFG)):
        assert (tmodule.count_params(tT.param_defs(c))
                == jmodule.count_params(jT.param_defs(j)))
        assert tT.layer_windows(c) == jT.layer_windows(j)
        assert tT.padded_vocab(c) == jT.padded_vocab(j)
    wins = tT.layer_windows(tc)
    assert [i for i, w in enumerate(wins) if w is None] == [0, 15, 31]
    assert set(wins) == {None, 1024} and tT.padded_vocab(tc) == 32256
    assert round(tmodule.count_params(tT.param_defs(tc)) / 1e9, 3) == 1.394
    assert tssm.ssm_dims(tc) == (1600, 25, 64, 16)
    lp = tT.param_defs(TCFG)["layers"]
    assert {"attn", "ssm", "attn_out_norm", "ssm_out_norm", "ln1", "ln2",
            "mlp"} == set(lp)
    assert tT.layer_windows(TCFG) == [None, 32]


@pytest.mark.parametrize("unroll", [False, True])
def test_forward_and_loss_match_reference(model, unroll):
    """``forward`` and ``loss_fn`` against the reference scanned (its
    global layer on a traced window of 2^30) and unrolled (window
    None)."""
    jp, tp, _ = model
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 45)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 45)).astype(np.int32)
    want, want_loss = jax.jit(lambda p, t, l: (
        jT.forward(p, t, JCFG, unroll=unroll)[0],
        jT.loss_fn(p, t, l, JCFG, unroll=unroll)[0]))(jp, tokens, labels)
    with torch.no_grad():
        got, aux = tT.forward(tp, _t(tokens), TCFG)
        loss, m = tT.loss_fn(tp, _t(tokens), _t(labels), TCFG)
    _close(got, want)
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    assert float(m["loss"]) == float(loss)


def test_loss_gradients_match_reference(model):
    jp, _, flat = model
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (2, 37)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 37)).astype(np.int32)
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, tokens, labels, JCFG), has_aux=True))(jp)
    p = {k: _t(v).clone().requires_grad_() for k, v in flat.items()}
    total, _ = tT.loss_fn(tmodule.unflatten(p), _t(tokens), _t(labels), TCFG)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_loss),
                               rtol=1e-5)
    for k, w in _flat_jax(want).items():
        np.testing.assert_allclose(
            p[k].grad.numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=k)
    assert float(p["layers.ssm_out_norm"].grad.abs().max()) > 0


def test_prefill_and_decode_past_the_window(model, monkeypatch):
    """``prefill`` of 40 tokens (past the local layer's window of 32: its
    ring wraps) to caches of 48 slots, then 12 ``decode_step``s (the ring
    wraps again, the SSM state carried step to step): the logits of each,
    and every layer's K/V ring, positions, conv rings and state.  The
    prefill runs ``decay_scan`` once a layer, a decode step never."""
    jp, tp, _ = model
    tokens = np.random.default_rng(6).integers(0, 256, (2, 52)).astype(
        np.int32)
    jl, jcache, _ = jax.jit(lambda p, t: jT.prefill(p, t, JCFG, max_len=48))(
        jp, tokens[:, :40])
    jdec = jax.jit(lambda p, t, c, pos: jT.decode_step(p, t, c, pos, JCFG))
    calls = []
    plain = tops.decay_scan
    monkeypatch.setattr(tops, "decay_scan",
                        lambda *a: calls.append(1) or plain(*a))
    with torch.inference_mode():
        tl, tcache, tpos = tT.prefill(tp, _t(tokens[:, :40]), TCFG, 48)
        assert tpos == 40 and len(calls) == TCFG.n_layers
        _close(tl, jl)
        _caches_equal(tcache, jcache)
        for i in range(40, 52):
            jl, jcache = jdec(jp, tokens[:, i:i + 1], jcache, jnp.int32(i))
            tl, tcache = tT.decode_step(tp, _t(tokens[:, i:i + 1]), tcache,
                                        i, TCFG)
            _close(tl, jl)
        _caches_equal(tcache, jcache)
    assert len(calls) == TCFG.n_layers
    assert [c["k"].shape[1] for c in tcache] == [48, 32]
    assert int(tcache[1]["pos"].min()) == 52 - 32


def test_decode_from_empty_caches_matches_forward(model):
    """``init_decode_caches`` gives a hybrid layer its ring and its SSM
    state in one dict; 20 decode steps from them (the local ring of 8
    slots wraps) equal ``forward``'s logits."""
    _, tp, _ = model
    cfg = dataclasses.replace(TCFG, window=8)
    tokens = _t(np.random.default_rng(7).integers(0, 256, (2, 20)).astype(
        np.int32))
    caches = tT.init_decode_caches(cfg, 2, 20, device="cpu")
    assert sorted(caches[1]) == ["k", "pos", "ssm", "v"]
    assert caches[1]["k"].shape[1] == 8 and caches[0]["k"].shape[1] == 20
    with torch.inference_mode():
        want, _ = tT.forward(tp, tokens, cfg)
        for i in range(20):
            got, caches = tT.decode_step(tp, tokens[:, i:i + 1], caches, i,
                                         cfg)
            _close(got[:, 0], want[:, i])


def test_serve_engine_matches_reference(model):
    """Three prompts of unequal length, left-padded with token 0, the
    longest past the window: greedy tokens equal the JAX engine's."""
    jp, tp, _ = model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 23, 35)]
    je = jengine.ServeEngine(JCFG, jp, max_len=64)
    te = tengine.ServeEngine(TCFG, tp, max_len=64, device="cpu")
    jres = je.serve([jengine.Request(p, max_new_tokens=6) for p in prompts])
    tres = te.serve([tengine.Request(p, max_new_tokens=6) for p in prompts])
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_prefill, t.n_decoded) == (j.n_prefill, j.n_decoded)


def test_convert_round_trips(model):
    """The hybrid leaves cross both ways bitwise; the reference's caches of
    a hybrid layer (ring and SSM state in one dict, int8 or not) cross
    into the port's layout and back."""
    jp, tp, flat = model
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(flat)
    assert {"layers.attn_out_norm", "layers.ssm_out_norm",
            "layers.ssm.z_proj", "layers.attn.wq"} <= set(back)
    for k in flat:
        np.testing.assert_array_equal(back[k].view(np.int32),
                                      flat[k].view(np.int32))
    for kv in ("bfloat16", "int8"):
        jc = dataclasses.replace(JCFG, kv_cache_dtype=kv)
        tc = dataclasses.replace(TCFG, kv_cache_dtype=kv)
        want = [_flat_jax(c) for c in jT.init_decode_caches(jc, 2, 40)]
        for c in want:
            c["ssm.state"] = np.random.default_rng(0).standard_normal(
                c["ssm.state"].shape).astype(np.float32)
        caches = convert.decode_caches_from_numpy(want, tc, "cpu")
        assert caches[1]["k"].shape[1] == 32 and "ssm" in caches[1]
        for got, w in zip(convert.decode_caches_to_numpy(caches), want):
            assert set(got) == set(w)
            for k in w:
                np.testing.assert_array_equal(
                    got[k], np.asarray(w[k], got[k].dtype), err_msg=k)
        if kv == "int8":
            assert caches[1]["k_scale"].dtype == torch.bfloat16
    jcache = jax.jit(lambda p, t: jT.prefill(p, t, JCFG, max_len=48))(
        jp, np.zeros((1, 9), np.int32))[1]
    caches = convert.decode_caches_from_numpy(
        [_flat_jax(c) for c in jcache], TCFG, "cpu")
    assert caches[0]["ssm"]["state"].dtype == torch.float32


def test_launch_tokens_matches_reference(capsys):
    """``tokens --arch hymba-1.5b --reduced`` on the CPU prints the JAX
    CLI's request lines: weights from ``PRNGKey(0)`` in both packages."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    serve.main(["tokens", "--arch", ARCH, "--reduced", "--requests", "3",
                "--new-tokens", "5", "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req ")]
    jserve.run_tokens(argparse.Namespace(arch=ARCH, reduced=True,
                                         requests=3, new_tokens=5,
                                         max_len=128))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    assert len(got) == 3 and got == want
