"""The LM trainer over a mesh of CPU ranks (gloo), against the reference's
mesh trainer and the one-device port.

One ``torch.multiprocessing.spawn`` of 4 gloo ranks (a ``file://`` store
under ``tmp_path``, so xdist workers never share a port) runs every
mesh check once and rank 0 writes the results; the reference's checks
run once in a subprocess with 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), as
``tests/test_distributed.py`` runs them, while the ranks work.  Reduced
configs, ``fsdp=True``, 2 microbatches, 8 x 16 tokens a step, 2 steps.
The ``-b`` runs take smaller batches, whose microbatches the data ranks
do not divide (2 or 3 rows over 4 ranks, 1 over 2): each rank pads its
block, as GSPMD pads the reference's.

Bands: the loss within 1e-5 relative; parameters rtol 1e-4, atol 1e-4 x
max|leaf| (as ``test_torch_train.py``); restores bitwise; the pipeline
bitwise against its stages run in turn.  The MoE runs (grok-1's family)
train at lr 1e-3 (0 at step 0), once with AdamW and a float32
accumulator and once with the config's own Adafactor and bfloat16
accumulator.  Their update (new less initial parameter) is held within
``test_torch_moe.UPDATE_TOL`` (2^-6) x max|update of its leaf|, the band
of the one-device MoE step: a normalised step takes cells whose gradient
sits at rounding level a whole step in one package and a fraction in
the other (Adafactor's eps is 1e-30).  Quantities at the gradient's
scale are held too: AdamW's first moments in the parameters' band, and
Adafactor's second moments behind the bfloat16 accumulator in 2^-6 (a
cell of that accumulator may round one bfloat16 ULP apart).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.events.pipeline import TokenPipeline
from repro_torch.models import module as M
from repro_torch.train.loop import Trainer, TrainerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
BATCH, SEQ, STEPS = 8, 16, 2

#: (name, arch, mesh shape, config overrides, trainer overrides)
RUNS = [
    ("qwen3-4x1", "qwen3-8b", (4, 1), {}, {}),
    ("qwen3-2x2", "qwen3-8b", (2, 2), {}, {}),
    ("qwen3-2x2-once", "qwen3-8b", (2, 2), {"fsdp_gather_once": True}, {}),
    ("qwen3-1x4", "qwen3-8b", (1, 4), {}, {}),
    ("glm4-2x2", "glm4-9b", (2, 2), {}, {}),
    ("mamba2-2x2", "mamba2-2.7b", (2, 2), {}, {}),
    ("hymba-2x2", "hymba-1.5b", (2, 2), {}, {}),
    # updates far above the weights' rounding (the schedule's lr is 0 at
    # step 0, then the whole lr with one warm-up step)
    ("grok-2x2", "grok-1-314b", (2, 2), {"accum_dtype": "float32",
                                         "optimizer": "adamw"},
     {"lr": 1e-3, "warmup_steps": 1}),
    # grok-1's own Adafactor and bfloat16 accumulator, per layer and
    # gathered once
    ("grok-2x2-own", "grok-1-314b", (2, 2), {},
     {"lr": 1e-3, "warmup_steps": 1}),
    ("grok-2x2-own-once", "grok-1-314b", (2, 2), {"fsdp_gather_once": True},
     {"lr": 1e-3, "warmup_steps": 1}),
    ("adafactor-2x2", "qwen3-8b", (2, 2), {"optimizer": "adafactor"}, {}),
    ("topk-2x2", "qwen3-8b", (2, 2), {}, {"grad_compression": "topk"}),
    ("int8-2x2", "qwen3-8b", (2, 2), {}, {"grad_compression": "int8"}),
    # microbatches of fewer rows than data ranks, or of rows they do not
    # divide: padded blocks (gemma2-27b's 16 rows over 32 ranks in small)
    ("qwen3-4x1-b4", "qwen3-8b", (4, 1), {}, {}),
    ("qwen3-4x1-b6", "qwen3-8b", (4, 1), {}, {}),
    ("qwen3-4x1-b6-once", "qwen3-8b", (4, 1),
     {"fsdp_gather_once": True, "accum_dtype": "bfloat16"}, {}),
    ("mamba2-2x2-b2", "mamba2-2.7b", (2, 2), {}, {}),
]
#: the batch of each run that does not take BATCH
RUN_BATCH = {"qwen3-4x1-b4": 4, "qwen3-4x1-b6": 6, "qwen3-4x1-b6-once": 6,
             "mamba2-2x2-b2": 2}
#: the runs the reference's mesh trainer repeats
REF_RUNS = ["qwen3-4x1", "qwen3-2x2", "grok-2x2", "grok-2x2-own",
            "qwen3-4x1-b4", "qwen3-4x1-b6", "qwen3-4x1-b6-once",
            "mamba2-2x2-b2"]
#: refused shapes, (arch, mesh shape, batch): a batch that the 2
#: microbatches do not divide, and grok-1's microbatch of 1 row over 2
#: data ranks, which its expert layers do not take
REFUSED = {"batch": ("qwen3-8b", (4, 1), 5), "moe": ("grok-1-314b", (2, 2), 2)}
UPDATE_TOL = 2.0 ** -6
#: the runs whose optimizer moments at the gradient's scale are held
#: against the reference's: (the state's names, rtol = atol share).
#: AdamW's first moments (the clipped gradients of both steps; the lr is
#: 0 at step 0) in the band of the parameters; Adafactor's second
#: moments behind a bfloat16 accumulator, whose cells may round one
#: bfloat16 ULP (2^-8) apart at each of its roundings, in UPDATE_TOL
STATE_RUNS = {"qwen3-2x2": (("m",), 1e-4), "grok-2x2": (("m",), 1e-4),
              "grok-2x2-own": (("v", "vr", "vc"), UPDATE_TOL),
              "qwen3-4x1-b6": (("m",), 1e-4)}
#: runs held against the one-device port (an expert layer runs
#: ``moe_sharded`` over a mesh, whose capacity drops ``moe_dense`` lacks)
ONE_DEVICE_RUNS = [r[0] for r in RUNS if not r[0].startswith("grok")]

MOE_CFG = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=2, head_dim=16, d_ff=0, vocab=64, dtype="float32")
MOE_CASES = {"ep": ((2, 2), dict(n_experts=8, top_k=2, d_ff_expert=32,
                                 capacity_factor=1.0)),
             "tp": ((1, 4), dict(n_experts=2, top_k=1, d_ff_expert=32,
                                 capacity_factor=8.0))}
PP_STAGES, PP_MICRO, PP_MB, PP_D = 4, 8, 2, 16


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), fsdp=True,
                               n_microbatches=2, **kw)


def _moe_inputs(kind):
    shape, kw = MOE_CASES[kind]
    rng = np.random.default_rng(3)
    e, d, f = kw["n_experts"], MOE_CFG["d_model"], kw["d_ff_expert"]
    w = {"router": rng.standard_normal((d, e)) / d ** 0.5,
         "we_gate": rng.standard_normal((e, d, f)) / d ** 0.5,
         "we_up": rng.standard_normal((e, d, f)) / d ** 0.5,
         "we_down": rng.standard_normal((e, f, d)) / f ** 0.5}
    x = rng.standard_normal((4, 8, d))
    return ({k: v.astype(np.float32) for k, v in w.items()},
            x.astype(np.float32))


def _pp_inputs():
    rng = np.random.default_rng(5)
    ws = rng.standard_normal((PP_STAGES, PP_D, PP_D)) / PP_D ** 0.5
    x = rng.standard_normal((PP_MICRO, PP_MB, PP_D))
    return ws.astype(np.float32), x.astype(np.float32)


# ----------------------------------------------------------- the ranks

def _rank(rank, store, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import pp
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.train import optimizer as O

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    res = {}

    def full(tree, shards):
        return {k: SH.gather_full(x, pl).float().numpy() for (k, x), pl in zip(
            M.flatten(tree).items(), M.flatten(shards).values())}

    ckpt = os.path.join(out_dir, "ckpt")
    for name, arch, shape, kw, tkw in RUNS:
        mesh = make_test_mesh(shape, device="cpu")
        cfg = _cfg(arch, **kw)
        tcfg = TrainerConfig(**tkw, ckpt_dir=ckpt if name == "qwen3-4x1"
                             else None)
        tr = Trainer(cfg, tcfg, mesh=mesh)
        tr.train(TokenPipeline(cfg.vocab, RUN_BATCH.get(name, BATCH), SEQ,
                               seed=0), STEPS)
        res[f"{name}/loss"] = np.array([h["loss"] for h in tr.history])
        for k, v in full(tr.params, tr.shards).items():
            res[f"{name}/p/{k}"] = v
        if name == "qwen3-4x1":
            tr.save()
        for k, v in full(tr.opt_state, tr.opt.state_shards(tr.shards)
                         ).items():
            res[f"{name}/s/{k}"] = v
        if name == "qwen3-2x2":
            # the (4, 1) checkpoint restored onto (2, 2)
            tr2 = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt), mesh=mesh)
            assert tr2.maybe_restore() and tr2.step == STEPS
            for k, v in full(tr2.params, tr2.shards).items():
                res[f"restored-2x2/p/{k}"] = v
            for k, v in full(tr2.opt_state, tr2.opt.state_shards(tr2.shards)
                             ).items():
                res[f"restored-2x2/s/{k}"] = v
            # global_norm over the blocks of a tree of random leaves
            rng = np.random.default_rng(11)
            whole = {k: torch.from_numpy(rng.standard_normal(pl.shape)
                                         .astype(np.float32))
                     for k, pl in M.flatten(tr.shards).items()}
            blocks = M.unflatten({k: SH.shard_leaf(v, M.flatten(
                tr.shards)[k]) for k, v in whole.items()})
            res["norm/mesh"] = O.global_norm(blocks, tr.shards).numpy()
            res["norm/one"] = O.global_norm(M.unflatten(whole)).numpy()

    for kind, (shape, kw) in MOE_CASES.items():
        mesh = make_test_mesh(shape, device="cpu")
        cfg = ModelConfig(**MOE_CFG, **kw)
        w, x = _moe_inputs(kind)
        up, down = MOE.expert_weight_specs(cfg, mesh.shape["model"])
        specs = {"router": (None, None), "we_gate": up, "we_up": up,
                 "we_down": down}
        params = {k: SH.shard_leaf(torch.from_numpy(v), SH.Placement(
            v.shape, specs[k], mesh)) for k, v in w.items()}
        rows = SH.Placement(x.shape, (("data",), None, None), mesh)
        xl = SH.shard_leaf(torch.from_numpy(x), rows)
        y, aux = MOE.moe_sharded(params, xl, cfg, mesh)
        res[f"moe-{kind}/y"] = SH.gather_full(y, rows).numpy()
        for k, v in aux.items():
            res[f"moe-{kind}/{k}"] = v.detach().numpy()

    mesh = make_test_mesh((PP_STAGES,), ("stage",), device="cpu")
    ws, x = _pp_inputs()
    stage = lambda w, h: torch.tanh(h @ w)
    got = pp.pipeline_forward(stage, torch.from_numpy(ws),
                              torch.from_numpy(x), mesh)
    res["pp/y"] = got.numpy()

    mesh = make_test_mesh((2, 2), device="cpu")
    from repro_torch.events.pipeline import shard_batch
    rows = shard_batch({"t": np.arange(8 * 3).reshape(8, 3)}, mesh)
    res["shard_batch"] = rows["t"].numpy()
    res["shard_batch_rank"] = np.array(rank)

    # refusals that need a world
    for shape in ((2, 1), (8, 1)):
        try:
            make_test_mesh(shape, device="cpu")
        except ValueError as e:
            res[f"refused/{shape[0]}"] = np.array(str(e))
    for what, (arch, shape, batch) in REFUSED.items():
        cfg = _cfg(arch)
        tr = Trainer(cfg, TrainerConfig(), mesh=make_test_mesh(
            shape, device="cpu"))
        try:
            tr.train(TokenPipeline(cfg.vocab, batch, SEQ, seed=0), 1)
        except ValueError as e:
            res[f"refused/{what}"] = np.array(str(e))
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


_REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from test_torch_fsdp import (RUNS, REF_RUNS, STATE_RUNS, MOE_CASES, MOE_CFG,
                             BATCH, SEQ, STEPS, RUN_BATCH, REFUSED,
                             _moe_inputs, _pp_inputs, PP_STAGES)
import dataclasses
from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.distributed import pp
from repro.events.pipeline import TokenPipeline
from repro.launch.mesh import make_test_mesh
from repro.models import moe as MOE
from repro.train.loop import Trainer, TrainerConfig

out = {{}}
def flat(tree, prefix=""):
    o = {{}}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            o.update(flat(v, prefix + k + "."))
        else:
            o[prefix + k] = np.asarray(v)
    return o
for name, arch, shape, kw, tkw in RUNS:
    if name not in REF_RUNS:
        continue
    cfg = dataclasses.replace(get_config(arch).reduced(), fsdp=True,
                              n_microbatches=2, **kw)
    mesh = make_test_mesh(shape)
    with mesh:
        tr = Trainer(cfg, TrainerConfig(**tkw), mesh=mesh)
        for k, v in flat(tr.params).items():
            out[name + "/init/" + k] = v
        h = tr.train(TokenPipeline(cfg.vocab, RUN_BATCH.get(name, BATCH),
                                   SEQ, seed=0), STEPS)["history"]
    out[name + "/loss"] = np.array([x["loss"] for x in h])
    for k, v in flat(tr.params).items():
        out[name + "/p/" + k] = v
    if name in STATE_RUNS:
        for k, v in flat(tr.opt_state).items():
            out[name + "/s/" + k] = v.astype(np.float32)
for kind, (shape, kw) in MOE_CASES.items():
    cfg = ModelConfig(**MOE_CFG, **kw)
    w, x = _moe_inputs(kind)
    mesh = make_test_mesh(shape, ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda p, xx: MOE.moe_sharded(p, xx, cfg, mesh))(
            {{k: jnp.asarray(v) for k, v in w.items()}}, jnp.asarray(x))
    out["moe-" + kind + "/y"] = np.asarray(y)
    for k, v in aux.items():
        out["moe-" + kind + "/" + k] = np.asarray(v)
for what, (arch, shape, batch) in REFUSED.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), fsdp=True,
                              n_microbatches=2)
    mesh = make_test_mesh(shape)
    try:
        with mesh:
            Trainer(cfg, TrainerConfig(), mesh=mesh).train(
                TokenPipeline(cfg.vocab, batch, SEQ, seed=0), 1)
    except Exception as e:
        out["refused/" + what] = np.array(type(e).__name__ + ": " + str(e))
ws, x = _pp_inputs()
mesh = make_test_mesh((PP_STAGES,), ("stage",))
out["pp/y"] = np.asarray(pp.pipeline_forward(
    lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x), mesh))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results, reference results) of every mesh check."""
    out = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT.format(
            tests=os.path.join(REPO, "tests")), str(out / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_rank, (str(out / "store"), str(out)), nprocs=WORLD)
    finally:
        so, se = ref.communicate(timeout=600)
    assert ref.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    return (dict(np.load(out / "port.npz")), dict(np.load(out / "ref.npz")),
            str(out))


def _one_device(name):
    _, arch, _, kw, tkw = next(r for r in RUNS if r[0] == name)
    cfg = _cfg(arch, **kw)
    tr = Trainer(cfg, TrainerConfig(**tkw), device="cpu")
    tr.train(TokenPipeline(cfg.vocab, RUN_BATCH.get(name, BATCH), SEQ,
                           seed=0), STEPS)
    return (np.array([h["loss"] for h in tr.history]),
            {k: v.numpy() for k, v in M.flatten(tr.params).items()})


def _close(res, name, loss, params):
    np.testing.assert_allclose(res[f"{name}/loss"], loss, rtol=1e-5)
    keys = sorted(k[len(name) + 3:] for k in res
                  if k.startswith(f"{name}/p/"))
    assert keys == sorted(params)
    for k in keys:
        got, want = res[f"{name}/p/{k}"], params[k]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", REF_RUNS)
def test_mesh_trainer_matches_reference(runs, name):
    port, ref, _ = runs
    want = {k[len(name) + 3:]: v for k, v in ref.items()
            if k.startswith(f"{name}/p/")}
    if not name.startswith("grok"):
        _close(port, name, ref[f"{name}/loss"], want)
        return
    np.testing.assert_allclose(port[f"{name}/loss"], ref[f"{name}/loss"],
                               rtol=1e-5)
    _, arch, _, kw, _ = next(r for r in RUNS if r[0] == name)
    init = M.flatten(Trainer(_cfg(arch, **kw), device="cpu").params)
    assert set(init) == set(want)
    for k, w in want.items():
        want_u = w - ref[f"{name}/init/{k}"]
        got_u = port[f"{name}/p/{k}"] - init[k].numpy()
        scale = float(np.abs(want_u).max())
        assert scale > 0, k
        err = float(np.abs(got_u - want_u).max())
        assert err <= UPDATE_TOL * scale, (k, err / scale)


@pytest.mark.parametrize("name", sorted(STATE_RUNS))
def test_mesh_moments_match_reference(runs, name):
    """The optimizer's moments at the gradient's scale, which Adam's and
    Adafactor's per-cell normalisation of the update does not blur."""
    port, ref, _ = runs
    names, tol = STATE_RUNS[name]
    keys = sorted(k for k in ref if k.startswith(f"{name}/s/") and (
        k[len(name) + 3:].split(".")[0] in names
        or k.rsplit(".", 1)[1] in names))
    assert keys and all(k in port for k in keys)
    for k in keys:
        want = ref[k]
        np.testing.assert_allclose(port[k], want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()),
                                   err_msg=k)



@pytest.mark.parametrize("name", ONE_DEVICE_RUNS)
def test_mesh_trainer_matches_one_device(runs, name):
    port, _, _ = runs
    _close(port, name, *_one_device(name))


def test_gather_once_matches_per_microbatch_gathers(runs):
    port, _, _ = runs
    for shape in ("2x2",):
        base = f"qwen3-{shape}"
        _close(port, f"{base}-once", port[f"{base}/loss"],
               {k[len(base) + 3:]: v for k, v in port.items()
                if k.startswith(f"{base}/p/")})


def test_gather_once_rounds_as_per_layer_gathers(runs):
    """Behind a bfloat16 accumulator, gathered once, each microbatch's
    gradient is summed over the data ranks before it is rounded into the
    accumulator, as the per-layer gathers' backward sums it: grok-1's own
    run bitwise either way."""
    port, _, _ = runs
    base = "grok-2x2-own"
    keys = [k[len(base) + 1:] for k in port if k.startswith(f"{base}/p/")
            or k.startswith(f"{base}/s/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(port[f"{base}-once/{k}"],
                                      port[f"{base}/{k}"], err_msg=k)


def test_restore_across_meshes(runs):
    """The (4, 1) checkpoint, whole leaves on disk, restored onto (2, 2),
    onto one device and by the reference's ``Checkpointer``: bitwise."""
    from repro.checkpoint.ckpt import Checkpointer as JCheckpointer

    port, _, out = runs
    saved = {k[len("qwen3-4x1/"):]: v for k, v in port.items()
             if k.startswith("qwen3-4x1/p/") or k.startswith("qwen3-4x1/s/")}
    again = {k[len("restored-2x2/"):]: v for k, v in port.items()
             if k.startswith("restored-2x2/")}
    assert sorted(again) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(again[k], saved[k], err_msg=k)
    cfg = _cfg("qwen3-8b")
    one = Trainer(cfg, TrainerConfig(ckpt_dir=os.path.join(out, "ckpt")),
                  device="cpu")
    assert one.maybe_restore() and one.step == STEPS
    for k, v in M.flatten(one.params).items():
        np.testing.assert_array_equal(v.numpy(), saved[f"p/{k}"], err_msg=k)
    for k, v in M.flatten(one.opt_state).items():
        np.testing.assert_array_equal(v.numpy(), saved[f"s/{k}"], err_msg=k)
    # the reference reads the same files
    ck = JCheckpointer(os.path.join(out, "ckpt"))
    zeros = lambda t: M.unflatten({k: np.zeros_like(v.numpy())
                                   for k, v in M.flatten(t).items()})
    tree, extra = ck.restore((zeros(one.params), zeros(one.opt_state)))
    assert extra["step"] == STEPS
    for k, v in M.flatten(tree[0]).items():
        np.testing.assert_array_equal(np.asarray(v), saved[f"p/{k}"])


@pytest.mark.parametrize("kind", sorted(MOE_CASES))
def test_moe_sharded_matches_reference(runs, kind):
    port, ref, _ = runs
    y, want = port[f"moe-{kind}/y"], ref[f"moe-{kind}/y"]
    np.testing.assert_allclose(y, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(port[f"moe-{kind}/{k}"],
                                   ref[f"moe-{kind}/{k}"], rtol=1e-5)


def test_pipeline_forward(runs):
    """4 GPipe stages over 4 ranks: bitwise the stages run in turn, and
    within 1e-5 of the reference's (its bar)."""
    port, ref, _ = runs
    ws, x = _pp_inputs()
    want = torch.from_numpy(x).clone()
    for i in range(PP_MICRO):      # the pipeline's shapes
        for s in range(PP_STAGES):
            want[i] = torch.tanh(want[i] @ torch.from_numpy(ws[s]))
    np.testing.assert_array_equal(port["pp/y"], want.numpy())
    assert np.abs(port["pp/y"] - ref["pp/y"]).max() < 1e-5
    from repro_torch.distributed import pp
    assert abs(pp.bubble(4, 8) - 3 / 11) < 1e-12


def test_global_norm_over_blocks(runs):
    port, _, _ = runs
    np.testing.assert_allclose(port["norm/mesh"], port["norm/one"],
                               rtol=1e-6)


def test_shard_batch(runs):
    """Rank 0 of a (2, 2) mesh (data index 0) holds the batch's first
    half, on its device."""
    port, _, _ = runs
    np.testing.assert_array_equal(port["shard_batch"],
                                  np.arange(24).reshape(8, 3)[:4])


def test_mesh_refusals(runs, monkeypatch):
    """A world of another size, a batch that the microbatches do not
    divide and grok-1's microbatch that its data ranks do not divide
    (both refused by the reference too: its step asserts the first, its
    ``shard_map`` refuses the second), a CUDA mesh with no card, and the
    production mesh in a world of one."""
    from repro_torch.launch import mesh as tmesh

    port, ref, _ = runs
    assert "needs 2 ranks; this world has 4" in str(port["refused/2"])
    assert "needs 8 ranks" in str(port["refused/8"])
    assert ("batch 5 is not a multiple of n_microbatches = 2"
            in str(port["refused/batch"]))
    assert str(ref["refused/batch"]).startswith("AssertionError")
    assert ("expert layers (moe_sharded)" in str(port["refused/moe"])
            and "batch 2 gives microbatches of 1 rows, which 2 data ranks"
            in str(port["refused/moe"]))
    assert "not evenly divisible" in str(ref["refused/moe"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_test_mesh((1, 1))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
