"""The port's event-classification LM (``repro_torch.train.event_lm``, the
protocol of ``examples/train_event_classifier.py``) vs the JAX package, on
the CPU, at tiny widths (d_model 64, 2 layers, 3 classes).

The SAEs are bitwise the reference's; step 0's loss, from the port's
``PRNGKey(0)`` weights carried into the reference's modules, within rtol
2e-5 of the example's ``apply`` (the dense family's band,
``tests/test_torch_dense.py``).  Step 0's gradients, through the
decoder, the embeds and the frontend, within rtol 1e-4 and atol 1e-4 x
max|leaf| of ``jax.grad`` of it (``tests/test_torch_train.py``'s band),
at the example's weights with the attention projections scaled to their
true fan-in: at the example's own weights the reference's gradients move
by more than that band when its weights move by half an ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import edram as jedram
from repro.core import time_surface as jts
from repro.events import datasets as jdatasets
from repro.events import pipeline as jpipeline
from repro.models import frontends as jfrontends
from repro.models import transformer as jT
from repro.configs.base import ModelConfig as JModelConfig
from repro_torch.models import module as tmodule
from repro_torch.train import event_lm
from repro_torch.train.grad import value_and_grad

jax.config.update("jax_platforms", "cpu")

WIDTHS = dict(d_model=64, layers=2, classes=3)
GRAD_TOL = 1e-4   # the train tests' band: rtol, and atol x max|leaf|


def _reference_apply(p, saes, labels, cfg, classes):
    """``examples/train_event_classifier.py``'s ``apply``."""
    embeds = jfrontends.event_ts_frontend(
        p["frontend"], saes, 0.2, cfg, decay=jedram.decay_params_for_cmem(),
        patch=8)
    tokens = jnp.full((saes.shape[0], 1), cfg.vocab - 1, jnp.int32)
    logits, _ = jT.forward(p["lm"], tokens, cfg, embeds=embeds)
    cls = logits[:, -1, :classes]
    lp = jax.nn.log_softmax(cls)
    return -jnp.take_along_axis(lp, labels[:, None], 1).mean()


def test_event_lm_step0_loss_matches_reference():
    out = event_lm.run(steps=2, device="cpu", batch=4, **WIDTHS)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["accuracy"] <= 1.0
    cfg = out["cfg"]
    jcfg = JModelConfig(**{**cfg.__dict__})
    assert jcfg.frontend == "event_ts" and jcfg.frontend_seq == 36

    saes, labels, n_test = event_lm.dataset(3, "cpu")
    streams = jdatasets.nmnist_like(n_classes=3, per_class=5, h=48, w=48,
                                    duration=0.2, seed=1)
    jsaes = np.stack([np.asarray(jts.sae_update(
        jts.empty_sae(48, 48), jpipeline.to_event_batch(s, 8192)))
        for s in streams])
    np.testing.assert_array_equal(saes.numpy(), jsaes)
    np.testing.assert_array_equal(labels.numpy(),
                                  [s.label for s in streams])

    init = event_lm.init(cfg, "cpu")
    jparams = {part: tmodule.unflatten({
        k: jnp.asarray(v.numpy()) for k, v in tmodule.flatten(tree).items()})
        for part, tree in init.items()}
    sel = np.random.default_rng(0).choice(np.arange(n_test, len(streams)), 4)
    want = _reference_apply(jparams, jnp.asarray(jsaes[sel]),
                            jnp.asarray(labels.numpy()[sel]), jcfg, 3)
    got, _ = event_lm.apply(init, saes[torch.from_numpy(sel)],
                            labels[torch.from_numpy(sel)], cfg, 3)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    np.testing.assert_allclose(out["losses"][0], float(want), rtol=2e-5)


def _true_fan_in(init, cfg):
    """``init`` with its attention projections scaled from the reference
    initialiser's fan-in (a 3-D leaf's heads dim) to their true one
    (d_model; heads x head_dim for ``wo``), as the dense tests draw them."""
    out = {part: dict(tmodule.flatten(tree)) for part, tree in init.items()}
    for w, ref_fan, fan in (("wq", cfg.n_heads, cfg.d_model),
                            ("wk", cfg.n_kv_heads, cfg.d_model),
                            ("wv", cfg.n_kv_heads, cfg.d_model),
                            ("wo", cfg.head_dim, cfg.n_heads * cfg.head_dim)):
        k = f"layers.attn.{w}"
        out["lm"][k] = out["lm"][k] * (ref_fan / fan) ** 0.5
    return {part: tmodule.unflatten(flat) for part, flat in out.items()}


def _jax_tree(tree):
    return tmodule.unflatten({k: jnp.asarray(v.detach().numpy())
                              for k, v in tmodule.flatten(tree).items()})


def test_event_lm_step0_gradients_match_reference():
    cfg = event_lm.config(**WIDTHS)
    jcfg = JModelConfig(**{**cfg.__dict__})
    saes, labels, n_test = event_lm.dataset(3, "cpu")
    sel = np.random.default_rng(0).choice(np.arange(n_test, len(labels)), 4)
    x, y = saes[torch.from_numpy(sel)], labels[torch.from_numpy(sel)]
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jgrad = jax.jit(jax.grad(_reference_apply), static_argnums=(3, 4))

    # the witness for the scaling: at the example's own weights a
    # half-ulp move of every weight moves the reference's gradients by
    # more than the band
    init = {part: _jax_tree(t) for part, t in
            event_lm.init(cfg, "cpu").items()}
    rng = np.random.default_rng(9)
    moved = jax.tree_util.tree_map(lambda w: w * (1 + 6e-8 * jnp.asarray(
        rng.standard_normal(w.shape), jnp.float32)), init)
    a, b = (tmodule.flatten(jgrad(p, jx, jy, jcfg, 3)) for p in (init, moved))
    assert max(float(jnp.abs(a[k] - b[k]).max() / jnp.abs(a[k]).max())
               for k in a) > GRAD_TOL

    params = _true_fan_in(event_lm.init(cfg, "cpu"), cfg)
    (loss, _), grads = value_and_grad(
        lambda p, x, y: event_lm.apply(p, x, y, cfg, 3), has_aux=True)(
            params, x, y)
    jparams = {part: _jax_tree(t) for part, t in params.items()}
    np.testing.assert_allclose(
        float(loss), float(_reference_apply(jparams, jx, jy, jcfg, 3)),
        rtol=2e-5)
    want = tmodule.flatten(jgrad(jparams, jx, jy, jcfg, 3))
    got = tmodule.flatten(grads)
    assert set(got) == set(want)
    assert any(k.startswith("frontend") for k in got)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max(initial=0.0)), err_msg=k)
