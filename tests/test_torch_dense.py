"""The repro_torch dense LM family vs the JAX package, on the CPU.

The four dense architectures at ``reduced()`` in both packages (d_model
64, heads of 16, d_ff 128, vocab 256, window 32, float32): ``qwen3-8b``
(qk-norm), ``glm4-9b`` (partial RoPE, one KV head) and ``gemma2-27b``
(attention softcap 50, local then global, final softcap 30) at 2 layers,
``gemma3-4b`` at 6 (one 5:1 local:global period).  Weights and inputs
are drawn with numpy from a seed and cross into the port through
``repro_torch.convert``; the leaves the reference initialises to zeros
are noised so that each of them matters.  The attention projections are
drawn with their true fan-in (``d_model`` for ``wq`` / ``wk`` / ``wv``,
``heads x head_dim`` for ``wo``): the reference's initialiser takes the
last-but-one dim (the heads) as a 3-D leaf's fan-in, which makes the
attention logits of the unnormed configs ~100 and the softmax one-hot,
so that a rounding difference in a projection (1e-7 relative) moves the
logits by 1e-3 after two layers; drawn so, both packages run in the
softmax's ordinary range.

Band, as ``tests/test_torch_lm.py``'s: rtol 2e-5 and atol 2e-5 x max(1,
max|want|): both sides are float32 and differ only in the order of sums
inside contractions.  Integer caches (positions, int8 codes) and bf16
scales are bitwise, greedy tokens equal.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro.models import module as jmodule
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as tL
from repro_torch.models import module as tmodule
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine

jax.config.update("jax_platforms", "cpu")

TOL = 2e-5
ARCHS = ("qwen3-8b", "glm4-9b", "gemma2-27b", "gemma3-4b")
DENSE = ("qwen3-8b", "gemma3-4b", "gemma2-27b", "glm4-9b")


def _cfgs(arch, **kw):
    if arch == "gemma3-4b":
        kw = {"n_layers": 6, **kw}
    return jget_config(arch).reduced(**kw), tget_config(arch).reduced(**kw)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


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


def _caches_equal(tc, jc):
    """Port caches against the reference's: integer and bf16 leaves
    bitwise, float ones in the band."""
    for t, j in zip(convert.decode_caches_to_numpy(tc),
                    [_flat_jax(c) for c in jc]):
        assert set(t) == set(j)
        for k in t:
            if k in ("pos", "k_scale", "v_scale") or j[k].dtype == np.int8:
                np.testing.assert_array_equal(
                    t[k], np.asarray(j[k], t[k].dtype), err_msg=k)
            else:
                _close(t[k], j[k])


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("pos_2d", [False, True])
def test_apply_rope_matches_reference(fraction, pos_2d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 3000, (2, 19)) if pos_2d
           else np.arange(19) + 700).astype(np.int32)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction, 1e4)
    got = tL.apply_rope(_t(x), _t(pos), fraction, 1e4)
    _close(got, want)
    # the pass-through dims are untouched; the rotated ones move
    rot = int(16 * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], _t(x)[..., rot:])
    assert not torch.equal(got[..., :rot], _t(x)[..., :rot])
    np.testing.assert_array_equal(
        tL.rope_frequencies(16, fraction, 1e6).numpy(),
        np.asarray(jL.rope_frequencies(16, fraction, 1e6)))


@pytest.mark.parametrize("kw, s, sk, h, kh", [
    (dict(), 45, 45, 4, 2),                          # causal, G = 2
    (dict(window=12), 45, 45, 4, 1),                 # windowed, G = 4
    (dict(window=20, softcap=50.0), 37, 37, 2, 2),   # softcapped, G = 1
    (dict(q_offset=16), 21, 37, 4, 2),               # prefill continuation
    (dict(causal=False, softcap=30.0), 13, 29, 4, 4),
])
def test_blockwise_attention_matches_both_reference_modes(kw, s, sk, h, kh):
    """bq = bc = 8: many tiles, S and Sk not multiples of 8, the tiles the
    mask hides skipped by the port and merged (masked) by the reference's
    scan mode."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, s, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, kh, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, kh, 16)).astype(np.float32)
    got = tL.blockwise_attention(_t(q), _t(k), _t(v), bq=8, bc=8, **kw)
    for unroll in (False, True):
        want = jax.jit(lambda q, k, v: jL.blockwise_attention(
            q, k, v, bq=8, bc=8, unroll=unroll, **kw))(q, k, v)
        _close(got, want)


def test_blockwise_attention_backward_keeps_one_query_tile():
    """Under autograd each query tile is checkpointed, as the reference's
    scan mode remats its ``q_chunk``: what the forward keeps for the
    backward (distinct storages) is q, k and v, less than one (B, H, S,
    S) float32 score matrix, where the tiles' scores and weights would be
    several; the gradients match both of the reference's modes."""
    rng = np.random.default_rng(4)
    b, s, h, kh, d = 2, 128, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kw = dict(window=40, softcap=50.0, bq=8, bc=8)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    kept = {}

    def pack(t):
        kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tL.blockwise_attention(tq, tk, tv, **kw)
    assert sum(kept.values()) < 4 * b * h * s * s
    (out * _t(w)).sum().backward()
    for unroll in (False, True):
        want = jax.jit(jax.grad(lambda q, k, v: (jL.blockwise_attention(
            q, k, v, unroll=unroll, **kw) * w).sum(), argnums=(0, 1, 2)))(
                q, k, v)
        for got, wg in zip((tq.grad, tk.grad, tv.grad), want):
            _close(got, wg)


@pytest.mark.parametrize("window, softcap, vector_pos", [
    (None, None, False), (6, 50.0, False), (None, None, True)])
def test_decode_attention_on_a_ring(window, softcap, vector_pos):
    """A 10-slot ring that wrapped (slot p % 10 holds position p), with
    empty (-1) slots in one row and a future position in another."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    pos = np.array([[10, 11, 12, 13, 4, 5, 6, 7, 8, 9],
                    [0, 1, 2, 3, -1, -1, -1, -1, -1, -1],
                    [20, 21, 12, 13, 14, 15, 16, 17, 18, 19]], np.int32)
    qpos = np.array([13, 3, 19], np.int32) if vector_pos else 13
    want = jL.decode_attention(q, kc, vc, pos, jnp.asarray(qpos),
                               window=window, softcap=softcap)
    got = tL.decode_attention(_t(q), _t(kc), _t(vc), _t(pos),
                              _t(qpos) if vector_pos else qpos,
                              window=window, softcap=softcap)
    _close(got, want)


def test_attention_qkv_and_mlp_match_reference(models):
    """``attention_qkv`` with qk-norm at prefill positions, and the gated
    MLP, whose tanh GELU (``jax.nn.gelu``'s default) the erf form misses
    by far more than the band."""
    jc, tc, jp, tp, _ = models["qwen3-8b"]
    jlp = jax.tree_util.tree_map(lambda p: p[0], jp["layers"])
    tlp = tT.layer_params(tp, 0)
    x = np.random.default_rng(3).standard_normal((2, 23, 64)).astype(
        np.float32)
    pos = np.arange(23, dtype=np.int32)
    for got, want in zip(
            tL.attention_qkv(tlp["attn"], _t(x), tc, _t(pos)),
            jL.attention_qkv(jlp["attn"], jnp.asarray(x), jc, pos)):
        _close(got, want)
    want = jL.mlp_block(jlp["mlp"], jnp.asarray(x))
    _close(tL.mlp_block(tlp["mlp"], _t(x)), want)
    erf = tlp["mlp"]
    gate = torch.nn.functional.gelu(_t(x) @ erf["wi_gate"])
    y = (gate * (_t(x) @ erf["wi_up"])) @ erf["wo"]
    with pytest.raises(AssertionError):
        _close(y, want)


def test_kv_quantize_and_fill_ring_bitwise():
    """Codes round half to even, scales in bf16 (an all-zero row takes the
    1e-8 floor); ``_fill_ring`` pads a short prompt with empty slots and
    rolls a long one's tail into place, on both of its branches."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    x[0, 0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0, 0, 0, 0, 0, 0, 0,
                  0, 0]
    x[0, 1, 1] = 0
    for xx in (x, x.astype(jnp.bfloat16)):
        jq, js = jT.kv_quantize(jnp.asarray(xx))
        tq, ts = tT.kv_quantize(torch.from_numpy(np.asarray(xx, np.float32))
                                .to(torch.bfloat16 if xx.dtype != np.float32
                                    else torch.float32))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
        np.testing.assert_array_equal(
            tT.kv_dequantize(tq, ts, torch.float32).numpy(),
            np.asarray(jT.kv_dequantize(jq, js, jnp.float32)))
    np.testing.assert_array_equal(tq[0, 0, 0, :7].numpy(),
                                  [127, 0, 2, 2, 0, -2, 4])
    k = rng.standard_normal((2, 23, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 23, 2, 4)).astype(np.float32)
    for s_total, s_cache in ((23, 32), (23, 23), (23, 8), (23, 5)):
        want = jT._fill_ring(k[:, :s_total], v[:, :s_total], s_total,
                             s_cache)
        got = tT._fill_ring(_t(k[:, :s_total]), _t(v[:, :s_total]), s_total,
                            s_cache)
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


# ------------------------------------------------------------ the stack

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(models, arch):
    """``forward`` logits and ``loss_fn``, with and without a frontend's
    ``embeds`` (8 prepended positions; the loss on the token tail)."""
    jc, tc, jp, tp, _ = models[arch]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 40)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 40)).astype(np.int32)
    embeds = (rng.standard_normal((2, 8, 64)) * 0.5).astype(np.float32)
    jfe = dataclasses.replace(jc, frontend="event_ts", frontend_seq=8)
    tfe = dataclasses.replace(tc, frontend="event_ts", frontend_seq=8)
    for c_j, c_t, e in ((jc, tc, None), (jfe, tfe, embeds)):
        want, want_loss = jax.jit(lambda p, t, l, e: (
            jT.forward(p, t, c_j, embeds=e)[0],
            jT.loss_fn(p, t, l, c_j, embeds=e)[0]))(jp, tokens, labels, e)
        te = None if e is None else _t(e)
        with torch.no_grad():
            got, aux = tT.forward(tp, _t(tokens), c_t, embeds=te)
            loss, m = tT.loss_fn(tp, _t(tokens), _t(labels), c_t, embeds=te)
        assert got.shape == (2, 40 if e is None else 48, 256)
        _close(got, want)
        assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
        assert float(m["loss"]) == float(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_window(models, arch):
    """``prefill`` of 40 tokens (past the window of 32: the local rings
    wrap) to caches of 48 slots, then 12 ``decode_step``s (the rings wrap
    again): the logits of each, and every layer's caches."""
    jc, tc, jp, tp, _ = models[arch]
    tokens = np.random.default_rng(6).integers(0, 256, (2, 52)).astype(
        np.int32)
    jpre = jax.jit(lambda p, t: jT.prefill(p, t, jc, max_len=48))
    jdec = jax.jit(lambda p, t, c, pos: jT.decode_step(p, t, c, pos, jc))
    jl, jcache, jpos = jpre(jp, tokens[:, :40])
    with torch.inference_mode():
        tl, tcache, tpos = tT.prefill(tp, _t(tokens[:, :40]), tc, 48)
        assert tpos == int(jpos) == 40
        _close(tl, jl)
        _caches_equal(tcache, jcache)
        last, _, _ = tT.prefill(tp, _t(tokens[:, :40]), tc, 48,
                                last_logits_only=True)
        _close(last, np.asarray(jl)[:, -1:])
        for i in range(40, 52):
            jl, jcache = jdec(jp, tokens[:, i:i + 1], jcache, jnp.int32(i))
            tl, tcache = tT.decode_step(tp, _t(tokens[:, i:i + 1]), tcache,
                                        i, tc)
            _close(tl, jl)
        _caches_equal(tcache, jcache)
    kinds = tc.layer_kinds()
    sizes = [c["k"].shape[1] for c in tcache]
    assert sizes == [32 if k == "local" else 48 for k in kinds]


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-4b"])
def test_int8_cache_decode_matches_reference(models, arch):
    """12 ``decode_step``s from ``init_decode_caches`` with int8 K/V (the
    reference's int8 path) and a window of 8, so the local rings wrap:
    codes, scales and positions bitwise, logits in the band.  Decoding an
    int8 config from a prefill's unquantized caches raises in both
    packages."""
    jc0, tc0, jp, tp, _ = models[arch]
    jc = dataclasses.replace(jc0, kv_cache_dtype="int8", window=8)
    tc = dataclasses.replace(tc0, kv_cache_dtype="int8", window=8)
    tokens = np.random.default_rng(7).integers(0, 256, (2, 12)).astype(
        np.int32)
    jdec = jax.jit(lambda p, t, c, pos: jT.decode_step(p, t, c, pos, jc))
    jcache = jT.init_decode_caches(jc, 2, 16)
    tcache = tT.init_decode_caches(tc, 2, 16, device="cpu")
    with torch.inference_mode():
        for i in range(12):
            jl, jcache = jdec(jp, tokens[:, i:i + 1], jcache, jnp.int32(i))
            tl, tcache = tT.decode_step(tp, _t(tokens[:, i:i + 1]), tcache,
                                        i, tc)
            _close(tl, jl)
        _caches_equal(tcache, jcache)
        assert tcache[0]["k"].dtype == torch.int8
        # a prefill's caches: unquantized K/V and positions, no scales
        pre = tT.init_decode_caches(tc0, 2, 16, device="cpu")
        with pytest.raises(TypeError):
            tT.decode_step(tp, _t(tokens[:, :1]), pre, 12, tc)
    with pytest.raises(TypeError):
        jT.decode_step(jp, tokens[:, :1], jT.init_decode_caches(jc0, 2, 16),
                       jnp.int32(12), jc)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-4b"])
def test_serve_engine_matches_reference(models, arch):
    """Three prompts of unequal length, left-padded with token 0 (attended,
    as in the reference), the longest past the window: greedy tokens equal
    the JAX engine's."""
    jc, tc, jp, tp, _ = models[arch]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 23, 35)]
    je = jengine.ServeEngine(jc, jp, max_len=64)
    te = tengine.ServeEngine(tc, tp, max_len=64, device="cpu")
    jres = je.serve([jengine.Request(p, max_new_tokens=6) for p in prompts])
    tres = te.serve([tengine.Request(p, max_new_tokens=6) for p in prompts])
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_prefill, t.n_decoded) == (j.n_prefill, j.n_decoded)


# ----------------------------------------------------- configs and plumbing

def test_config_registry_matches_reference():
    for arch in DENSE:
        jc, tc = jget_config(arch), tget_config(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.layer_kinds() == jc.layer_kinds() and tc.fsdp
        assert tc.n_params() == jc.n_params()
        for c, j in ((tc, jc), _cfgs(arch)[::-1]):
            assert dataclasses.asdict(c) == dataclasses.asdict(j)
            assert (tmodule.count_params(tT.param_defs(c))
                    == jmodule.count_params(jT.param_defs(j)))
            assert tT.padded_vocab(c) == jT.padded_vocab(j)
            assert tT.layer_windows(c) == jT.layer_windows(j)
    qwen = tget_config("qwen3-8b")
    assert (qwen.vocab, tT.padded_vocab(qwen)) == (151936, 152064)
    assert round(qwen.n_params() / 1e9, 2) == 8.19
    assert tget_config("gemma3-4b").layer_kinds().count("global") == 5


def test_convert_round_trips(models):
    _, tc, _, tp, flat = models["gemma3-4b"]
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(flat) and "layers.attn.wq" in back
    for k in flat:
        np.testing.assert_array_equal(back[k].view(np.int32),
                                      flat[k].view(np.int32))
    for c in (tc, dataclasses.replace(tc, kv_cache_dtype="int8")):
        caches = tT.init_decode_caches(c, 2, 40, device="cpu")
        for layer in caches:
            layer["pos"][:, :3] = torch.arange(3, dtype=torch.int32)
            layer["k"][:, 1] = 3
        arrays = convert.decode_caches_to_numpy(caches)
        again = convert.decode_caches_from_numpy(arrays, c, "cpu")
        for a, b in zip(again, caches):
            assert set(a) == set(b)
            assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                       for k in a)
    with pytest.raises(KeyError):
        convert.decode_caches_from_numpy(
            [{"k": arrays[0]["k"]}] * tc.n_layers, tc, "cpu")


def test_launch_tokens_matches_reference(capsys):
    """``tokens --arch qwen3-8b --reduced`` on the CPU prints the JAX
    CLI's request lines: weights from ``PRNGKey(0)`` in both packages."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    serve.main(["tokens", "--arch", "qwen3-8b", "--reduced", "--requests",
                "3", "--new-tokens", "5", "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req ")]
    jserve.run_tokens(argparse.Namespace(arch="qwen3-8b", reduced=True,
                                         requests=3, new_tokens=5,
                                         max_len=128))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    assert len(got) == 3 and got == want
