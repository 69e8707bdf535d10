"""The repro_torch vlm and audio stubs vs the JAX package, on the CPU.

``internvl2-26b`` (a dense backbone behind 1024 precomputed patch
embeddings) and ``musicgen-large`` (MHA behind 256 conditioning frame
embeddings) at ``reduced()`` in both packages: 2 layers, d_model 64,
``frontend_seq`` 16, vocab 256, float32.  ``stub_embeddings_spec`` gives
the embeddings' shape and dtype; embeddings of that shape, weights and
tokens are drawn with numpy from a seed (the attention projections at
their true fan-in, as ``tests/test_torch_dense.py`` draws them).  Band as
there: logits rtol 2e-5, atol 2e-5 x max(1, max|want|); the loss 2e-5
relative; positions and greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import frontends as jfrontends
from repro.models import module as jmodule
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import frontends as tfrontends
from repro_torch.models import module as tmodule
from repro_torch.models import transformer as tT

jax.config.update("jax_platforms", "cpu")

TOL = 2e-5
ARCHS = ("internvl2-26b", "musicgen-large")


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _is_def(v):
    return isinstance(v, jmodule.ParamDef)


def _weights(cfg, seed=1):
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
                fan_in = d.shape[1]
            elif leaf == "wo" and ".attn." in k:
                fan_in = d.shape[1] * d.shape[2]
            else:
                fan_in = d.shape[-2]
            v = rng.standard_normal(d.shape) * d.scale / fan_in ** 0.5
        flat[k] = v.astype(np.float32)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(defs, is_leaf=_is_def),
        [jnp.asarray(flat[".".join(str(p.key) for p in path)])
         for path, _ in leaves])
    return jp, flat


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_embeddings_spec_match_reference(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_params() == jc.n_params()
    for c, j in ((tc, jc), (tc.reduced(), jc.reduced())):
        assert (tmodule.count_params(tT.param_defs(c))
                == jmodule.count_params(jT.param_defs(j)))
        for batch in (1, 3):
            shape, dtype = tfrontends.stub_embeddings_spec(c, batch)
            want = jfrontends.stub_embeddings_spec(j, batch)
            assert shape == want.shape == (batch, c.frontend_seq, c.d_model)
            assert str(dtype).split(".")[-1] == str(want.dtype)
    assert tc.frontend_seq == {"internvl2-26b": 1024,
                               "musicgen-large": 256}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_stub_embeds_matches_reference(arch):
    """``forward`` and ``loss_fn`` with ``embeds`` of the spec's shape
    prepended (the loss on the token tail), and a ``prefill`` whose
    positions count the frontend's first, against the reference."""
    jc, tc = jget_config(arch).reduced(), tget_config(arch).reduced()
    jp, flat = _weights(jc)
    tp = convert.lm_params_from_numpy(flat, tc, "cpu")
    rng = np.random.default_rng(5)
    shape, dtype = tfrontends.stub_embeddings_spec(tc, 2)
    assert dtype == torch.float32
    embeds = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 24)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 24)).astype(np.int32)
    want, want_loss, want_pre = jax.jit(lambda p, t, l, e: (
        jT.forward(p, t, jc, embeds=e)[0],
        jT.loss_fn(p, t, l, jc, embeds=e)[0],
        jT.prefill(p, t, jc, max_len=48, embeds=e)))(jp, tokens, labels,
                                                     embeds)
    with torch.inference_mode():
        got, _ = tT.forward(tp, _t(tokens), tc, embeds=_t(embeds))
        loss, _ = tT.loss_fn(tp, _t(tokens), _t(labels), tc,
                             embeds=_t(embeds))
        pre, caches, pos = tT.prefill(tp, _t(tokens), tc, 48,
                                      embeds=_t(embeds))
    assert got.shape == (2, 16 + 24, 256)
    _close(got, want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    _close(pre, want_pre[0])
    assert pos == int(want_pre[2]) == 40
    for c, j in zip(caches, want_pre[1]):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(j["pos"]))
        _close(c["k"], j["k"])
