"""LM serving over a mesh of CPU ranks (gloo), against the reference's
mesh decode and the one-device port.

One ``torch.multiprocessing.spawn`` of 4 gloo ranks (a ``file://`` store
under ``tmp_path``) runs every mesh case once and rank 0 writes the
results; the reference's ``prefill`` / ``decode_step(mesh=)`` run once in
a subprocess with 4 host devices, its caches placed in the
flash-decoding layout as ``tests/test_distributed.py`` places them,
while the ranks work.  Reduced configs in float32 with numpy weights
(the attention projections drawn at their true fan-in, the zero-init
leaves noised): qwen3 with 2 KV heads (split over a model axis of 2),
gemma2 with a window of 8 under a 12-token prompt (softcaps, local and
global layers; the rolled ring splits), hymba with a window of 8
(``decay_scan``'s plain version) and grok-1 (``moe_sharded`` at decode),
each over (2, 2), (1, 4) and (4, 1); qwen3 with a batch of 2 over (4, 1)
(the batch whole, the sequence over the data axis), an int8-KV decode
from ``init_decode_caches`` (the shards past the first are empty at
first), and a ``max_len`` of 15 that ``cache_seq_axes`` cannot split.
A prefill of 12 tokens, then 3 decode steps fed the seeded tokens.

Band: logits rtol 1e-4, atol 1e-4 x max|ref|; greedy tokens equal; the
caches gathered back in the same band, positions bitwise, int8 codes
and their bf16 scales bitwise.  A mesh of one rank is bitwise the
one-device port.  An expert layer runs ``moe_sharded`` over any mesh
(capacity drops ``moe_dense`` lacks), so grok-1 is held against the
reference's mesh run on the same mesh only.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
PROMPT, STEPS, MAX_LEN = 12, 3, 16
TOL = 1e-4
MESHES = ((2, 2), (1, 4), (4, 1))
ARCHS = {"qwen3": ("qwen3-8b", {"n_kv_heads": 2}),
         "gemma2": ("gemma2-27b", {"window": 8}),
         "hymba": ("hymba-1.5b", {"window": 8}),
         "grok": ("grok-1-314b", {})}

#: (name, config key, mesh shape, batch, max_len, int8 KV cache)
RUNS = [(f"{a}-{s[0]}x{s[1]}", a, s, 4, MAX_LEN, False)
        for a in ARCHS for s in MESHES] + [
    ("qwen3-4x1-b2", "qwen3", (4, 1), 2, MAX_LEN, False),
    ("qwen3-int8-1x4", "qwen3", (1, 4), 4, MAX_LEN, True),
    ("qwen3-unsplit-1x4", "qwen3", (1, 4), 4, 15, False),
]
#: the runs the reference repeats: each config once over (2, 2) (its
#: collectives change no value of a dense layer), grok-1 on every mesh
#: (the local token count sets the experts' capacity), the int8 decode
REF_RUNS = [r[0] for r in RUNS if r[2] == (2, 2) or r[1] == "grok"
            or r[5]]
#: the serve requests: left-padded prompts, 4 greedy tokens each
SERVE_LENS = (12, 9, 12, 7)
SERVE_NEW = 4
#: the scan forms over a mesh (uniform layers for decode_step_scan),
#: and the mesh the reference runs them over (None: one device)
SCAN_RUNS = ("qwen3-2x2", "qwen3-1x4")
SCAN_REF = {"qwen3": None}
#: (mesh, batch, max_len) the layout is held on against the reference's
SPEC_CASES = (((2, 2), 4, 16), ((1, 4), 4, 15), ((1, 4), 4, 16),
              ((4, 1), 2, 16))


def _cfg(key, int8=False):
    arch, kw = ARCHS[key]
    if int8:
        kw = dict(kw, kv_cache_dtype="int8")
    return get_config(arch).reduced(**kw)


def _weights(cfg, seed=3):
    """{path: float32 array}: the reference's leaves, drawn with numpy
    (true fan-in for the attention projections; zero-init leaves
    noised)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in M.flatten(T.param_defs(cfg)).items():
        leaf = k.split(".")[-1]
        if d.init == "zeros":
            v = rng.standard_normal(d.shape) * 0.3
        elif d.init == "embed":
            v = rng.standard_normal(d.shape) * d.scale
        else:
            if ".attn." in k and leaf in ("wq", "wk", "wv"):
                fan = d.shape[1]
            elif ".attn." in k and leaf == "wo":
                fan = d.shape[1] * d.shape[2]
            else:
                fan = d.shape[-2]
            v = rng.standard_normal(d.shape) * d.scale / fan ** 0.5
        out[k] = v.astype(np.float32)
    return out


def _tokens(cfg, batch, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, PROMPT + STEPS)).astype(np.int32)


def _requests(cfg):
    rng = np.random.default_rng(6)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for n in SERVE_LENS]


def _run_args(name):
    return next(r for r in RUNS if r[0] == name)


def _decode(params, cfg, tok, max_len, int8, mesh=None, rows=slice(None),
            shards=None):
    """A prefill of PROMPT tokens (int8: empty caches) and STEPS decode
    steps fed ``tok``: (each call's logits, the caches).  Over ``mesh``,
    ``shards`` lays out the caches of the whole batch ``tok``."""
    batch = tok.shape[0]
    tok = torch.from_numpy(tok[rows])
    kw = {} if mesh is None else dict(mesh=mesh, cache_shards=shards)
    with torch.inference_mode():
        if int8:
            caches = T.init_decode_caches(cfg, batch, max_len, device="cpu")
            if mesh is not None:
                caches = SH.shard_caches(caches, shards)
            logits, start = [], 0
        else:
            lg, caches, start = T.prefill(
                params, tok[:, :PROMPT], cfg, max_len, last_logits_only=True,
                **kw)
            logits = [lg]
        for i in range(STEPS):
            lg, caches = T.decode_step(params, tok[:, start + i:start + i + 1],
                                       caches, start + i, cfg, **kw)
            logits.append(lg)
    return logits, caches


# ----------------------------------------------------------- the ranks

def _rank(rank, store, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    res = {}
    weights = {}
    for name, key, shape, batch, max_len, int8 in RUNS:
        mesh = make_test_mesh(shape, device="cpu")
        cfg = _cfg(key, int8)
        flat = weights.setdefault(key, _weights(cfg))
        full = convert.lm_params_from_numpy(flat, cfg, "cpu")
        blocks = M.unflatten({k: SH.shard_leaf(v, pl) for (k, v), pl in zip(
            M.flatten(full).items(), M.flatten(SH.placements(cfg, mesh))
            .values())})
        bspec = SH.batch_spec(mesh, batch)
        axes = bspec[0] if bspec else ()
        n, k = mesh.count(axes), mesh.index(axes)
        rows = slice(k * (batch // n), (k + 1) * (batch // n))
        shards = SH.cache_placements(cfg, mesh, batch, max_len)
        logits, caches = _decode(blocks, cfg, _tokens(cfg, batch), max_len,
                                 int8, mesh, rows, shards)
        for i, lg in enumerate(logits):
            lg = SH.all_gather_dim(lg, mesh, "model", -1)
            res[f"{name}/logits/{i}"] = SH.all_gather_dim(
                lg, mesh, axes, 0).numpy()
        for i, c in enumerate(SH.gather_caches(caches, shards)):
            for p, v in M.flatten(c).items():
                res[f"{name}/cache/{i}.{p}"] = v.float().numpy() if (
                    v.dtype == torch.bfloat16) else v.numpy()
        res[f"{name}/local_k"] = np.array(
            caches[-1]["k"].shape if "k" in caches[-1] else ())
        if key != "grok" and not int8 and max_len == MAX_LEN and batch == 4:
            got = ServeEngine(cfg, blocks, max_len=max_len, mesh=mesh).serve(
                _requests(cfg))
            res[f"{name}/serve"] = np.stack([r.tokens for r in got])
        if name in SCAN_RUNS:
            _scan_forms(res, name, cfg, mesh, blocks, rows, axes, batch,
                        max_len)
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def _scan_forms(res, name, cfg, mesh, blocks, rows, axes, batch, max_len):
    """decode_step_scan on the stacked caches of a mesh prefill, and
    prefill_scan's stacked K/V gathered back."""
    tok = torch.from_numpy(_tokens(cfg, batch)[rows])
    stacked_pl = SH.cache_placements(cfg, mesh, batch, max_len, stacked=True)
    with torch.inference_mode():
        lg, caches, start = T.prefill(
            blocks, tok[:, :PROMPT], cfg, max_len, mesh=mesh,
            last_logits_only=True,
            cache_shards=SH.cache_placements(cfg, mesh, batch, max_len))
        stacked = T.stack_caches(caches)
        for i in range(STEPS):
            lg, stacked = T.decode_step_scan(
                blocks, tok[:, start + i:start + i + 1], stacked, start + i,
                cfg, mesh=mesh, cache_shards=stacked_pl)
            lg = SH.all_gather_dim(lg, mesh, "model", -1)
            res[f"{name}/scan_logits/{i}"] = SH.all_gather_dim(
                lg, mesh, axes, 0).numpy()
        for p, v in M.flatten(SH.gather_caches(stacked, stacked_pl)).items():
            res[f"{name}/scan_cache/{p}"] = v.numpy()
        pscan_pl = SH.cache_placements(cfg, mesh, batch, PROMPT,
                                       stacked=True)
        lg, kv = T.prefill_scan(blocks, tok[:, :PROMPT], cfg, mesh=mesh,
                                cache_shards=pscan_pl)
    res[f"{name}/pscan_k"] = SH.gather_full(kv["k"], pscan_pl["k"]).numpy()
    lg = SH.all_gather_dim(lg, mesh, "model", -1)
    res[f"{name}/pscan_logits"] = SH.all_gather_dim(lg, mesh, axes,
                                                    0).numpy()


_REF_SCRIPT = """
import contextlib, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
jax.devices()          # the backend holds 4 devices before dryrun's import
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_serve_mesh import (RUNS, REF_RUNS, ARCHS, PROMPT, STEPS,
                                   SCAN_REF, SPEC_CASES, _weights, _tokens,
                                   _requests)
from repro.configs import get_config
from repro.distributed.sharding import batch_spec, cache_seq_axes
from repro.launch.dryrun import abstract_cache_specs
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as T

def cfg_of(key, int8=False):
    arch, kw = ARCHS[key]
    if int8:
        kw = dict(kw, kv_cache_dtype="int8")
    return get_config(arch).reduced(**kw)

def params_of(cfg):
    flat = _weights(cfg)
    def build(defs, prefix=""):
        return {{k: build(v, prefix + k + ".") if isinstance(v, dict)
                else jnp.asarray(flat[prefix + k]) for k, v in defs.items()}}
    return build(T.param_defs(cfg))

def flat(tree, prefix=""):
    out = {{}}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v.astype(jnp.float32)
                                         if v.dtype == jnp.bfloat16 else v)
    return out

def place(caches, mesh, batch):
    bspec = batch_spec(mesh, batch)
    b_ent = tuple(bspec) if len(bspec) else (None,)
    out = []
    for c in caches:
        cc = {{}}
        for k, v in c.items():
            if k == "ssm":
                cc[k] = jax.tree_util.tree_map(lambda a: jax.device_put(
                    a, NamedSharding(mesh, P(*b_ent, *([None] * (a.ndim - 1))))),
                    v)
                continue
            seq = cache_seq_axes(mesh, batch, v.shape[1]) or None
            cc[k] = jax.device_put(v, NamedSharding(
                mesh, P(*b_ent, seq, *([None] * (v.ndim - 2)))))
        out.append(cc)
    return out

out = {{}}
for name, key, shape, batch, max_len, int8 in RUNS:
    if name not in REF_RUNS:
        continue
    cfg = cfg_of(key, int8)
    params = params_of(cfg)
    tok = jnp.asarray(_tokens(cfg, batch))
    mesh = make_test_mesh(shape)
    with mesh:
        if int8:
            caches, start, logits = T.init_decode_caches(cfg, batch, max_len), 0, []
        else:
            lg, caches, start = jax.jit(lambda p, t: T.prefill(
                p, t, cfg, max_len=max_len, mesh=mesh,
                last_logits_only=True))(params, tok[:, :PROMPT])
            logits = [lg]
        caches = place(caches, mesh, batch)
        dec = jax.jit(lambda p, t, c, pos: T.decode_step(p, t, c, pos, cfg,
                                                         mesh=mesh))
        for i in range(STEPS):
            lg, caches = dec(params, tok[:, start + i:start + i + 1], caches,
                             jnp.int32(start + i))
            logits.append(lg)
    for i, lg in enumerate(logits):
        out[name + "/logits/" + str(i)] = np.asarray(lg)
    for i, c in enumerate(caches):
        for k, v in flat(c).items():
            out[name + "/cache/" + str(i) + "." + k] = v
# the scan forms
for key, shape in SCAN_REF.items():
    cfg = cfg_of(key)
    params = params_of(cfg)
    tok = jnp.asarray(_tokens(cfg, 4))
    mesh = None if shape is None else make_test_mesh(shape)
    with (mesh or contextlib.nullcontext()):
        lg, caches, start = jax.jit(lambda p, t: T.prefill(
            p, t, cfg, max_len=16, mesh=mesh, last_logits_only=True))(
            params, tok[:, :PROMPT])
        stacked = T.stack_caches(caches)
        dec = jax.jit(lambda p, t, c, pos: T.decode_step_scan(
            p, t, c, pos, cfg, mesh=mesh))
        for i in range(STEPS):
            lg, stacked = dec(params, tok[:, start + i:start + i + 1], stacked,
                              jnp.int32(start + i))
            out["scan/" + key + "/logits/" + str(i)] = np.asarray(lg)
        lg, kv = jax.jit(lambda p, t: T.prefill_scan(p, t, cfg, mesh=mesh))(
            params, tok[:, :PROMPT])
    for k, v in flat(stacked).items():
        out["scan/" + key + "/cache/" + k] = v
    out["scan/" + key + "/pscan_k"] = np.asarray(kv["k"])
    out["scan/" + key + "/pscan_logits"] = np.asarray(lg)
# the flash-decoding layout of abstract_cache_specs
def ent(e):
    return "" if e is None else ",".join((e,) if isinstance(e, str) else e)
for key in ARCHS:
    cfg = cfg_of(key)
    for shape, batch, max_len in SPEC_CASES:
        specs = abstract_cache_specs(cfg, batch, max_len,
                                     make_test_mesh(shape))
        for path, sds in jax.tree_util.tree_flatten_with_path(specs)[0]:
            k = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path)
            out["spec/" + key + "/" + str(shape) + "/" + str(batch) + "/"
                + str(max_len) + "/" + k] = np.array(
                "|".join(ent(e) for e in sds.sharding.spec))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results, reference results) of every mesh case."""
    out = tmp_path_factory.mktemp("serve_mesh")
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
    return dict(np.load(out / "port.npz")), dict(np.load(out / "ref.npz"))


_ONE = {}


def _one_device(name):
    """The one-device port on the whole batch: (logits, caches)."""
    if name not in _ONE:
        _, key, _, batch, max_len, int8 = _run_args(name)
        cfg = _cfg(key, int8)
        params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
        _ONE[name] = _decode(params, cfg, _tokens(cfg, batch), max_len, int8)
    return _ONE[name]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _hold(port, name, want_logits, want_cache, vocab):
    """The mesh run ``name`` against logits and caches (numpy, by
    call and by path): logits and float caches in the band, greedy
    tokens equal, integer and bf16 leaves bitwise."""
    n = sum(1 for k in port if k.startswith(f"{name}/logits/"))
    assert n == len(want_logits) > 0
    for i, want in enumerate(want_logits):
        got = port[f"{name}/logits/{i}"]
        _close(got, want, f"{name} call {i}")
        np.testing.assert_array_equal(got[..., :vocab].argmax(-1),
                                      want[..., :vocab].argmax(-1))
    keys = sorted(k[len(name) + 7:] for k in port
                  if k.startswith(f"{name}/cache/"))
    assert keys == sorted(want_cache)
    for k in keys:
        got, want = port[f"{name}/cache/{k}"], want_cache[k]
        if k.endswith(("pos", "_scale")) or want.dtype == np.int8:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=f"{name}: {k}")
        else:
            _close(got, want, f"{name}: {k}")


def _ref_of(ref, name):
    return ([ref[f"{name}/logits/{i}"] for i in range(
        sum(1 for k in ref if k.startswith(f"{name}/logits/")))],
        {k[len(name) + 7:]: v for k, v in ref.items()
         if k.startswith(f"{name}/cache/")})


@pytest.mark.parametrize("name", REF_RUNS)
def test_mesh_decode_matches_reference(runs, name):
    port, ref = runs
    key = _run_args(name)[1]
    _hold(port, name, *_ref_of(ref, name), _cfg(key).vocab)


@pytest.mark.parametrize("name", [r[0] for r in RUNS if r[1] != "grok"])
def test_mesh_decode_matches_one_device(runs, name):
    port, _ = runs
    key = _run_args(name)[1]
    logits, caches = _one_device(name)
    want = {f"{i}.{p}": (v.float() if v.dtype == torch.bfloat16 else v
                         ).numpy()
            for i, c in enumerate(caches) for p, v in M.flatten(c).items()}
    _hold(port, name, [lg.numpy() for lg in logits], want, _cfg(key).vocab)


def test_sequence_splits_as_the_layout_says(runs):
    """Each rank's last-layer K block: a quarter of the ring over (1, 4),
    half over (2, 2) (with half the batch), whole when the batch takes
    the data axis of (4, 1) or ``max_len`` does not divide."""
    port, _ = runs
    got = {n: tuple(port[f"{n}/local_k"]) for n in
           ("qwen3-1x4", "qwen3-2x2", "qwen3-4x1", "qwen3-4x1-b2",
            "qwen3-unsplit-1x4", "gemma2-1x4")}
    assert got == {"qwen3-1x4": (4, 4, 2, 16), "qwen3-2x2": (2, 8, 2, 16),
                   "qwen3-4x1": (1, 16, 2, 16), "qwen3-4x1-b2": (2, 4, 2, 16),
                   "qwen3-unsplit-1x4": (4, 15, 2, 16),
                   "gemma2-1x4": (4, 4, 1, 16)}


@pytest.mark.parametrize("name", [r[0] for r in RUNS if r[4] == MAX_LEN
                                  and r[3] == 4 and not r[5]
                                  and r[1] != "grok"])
def test_mesh_serve_engine_tokens(runs, name):
    """``ServeEngine(mesh=)`` over left-padded prompts: the tokens every
    rank returns are those of the one-device engine."""
    port, _ = runs
    cfg = _cfg(_run_args(name)[1])
    got = port[f"{name}/serve"]
    assert got.shape == (len(SERVE_LENS), SERVE_NEW)
    params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
    want = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu").serve(
        _requests(cfg))
    np.testing.assert_array_equal(got, np.stack([r.tokens for r in want]))


@pytest.mark.parametrize("name", SCAN_RUNS)
def test_scan_forms_match_reference(runs, name):
    """decode_step_scan on stack_caches over a mesh, and prefill_scan's
    stacked K/V, against the reference's scan forms on one device."""
    port, ref = runs
    r = f"scan/{name.split('-')[0]}/"
    for i in range(STEPS):
        _close(port[f"{name}/scan_logits/{i}"], ref[f"{r}logits/{i}"],
               f"{name} scan step {i}")
    keys = sorted(k[len(r) + 6:] for k in ref if k.startswith(f"{r}cache/"))
    assert keys == sorted(k[len(name) + 12:] for k in port
                          if k.startswith(f"{name}/scan_cache/"))
    for k in keys:
        got, want = port[f"{name}/scan_cache/{k}"], ref[f"{r}cache/{k}"]
        if k.endswith("pos"):
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, k)
    _close(port[f"{name}/pscan_k"], ref[f"{r}pscan_k"], "prefill_scan k")
    _close(port[f"{name}/pscan_logits"], ref[f"{r}pscan_logits"],
           "prefill_scan logits")


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_cache_specs_match_abstract_cache_specs(runs, key):
    """``sharding.cache_placements``' specs against the reference's
    ``dryrun.abstract_cache_specs`` in the cases of SPEC_CASES:
    the same spec for every K/V / pos / conv leaf; an SSM state splits
    over the batch only (the reference also puts its heads over
    ``"model"`` where they divide; the port's SSD decodes whole on every
    rank)."""
    _, ref = runs
    cfg = _cfg(key)
    ent = lambda e: "" if e is None else ",".join(
        (e,) if isinstance(e, str) else e)
    n = 0
    for shape, batch, max_len in SPEC_CASES:
        mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"),
                                                    shape)))
        specs = _flat_specs(SH.cache_placements(cfg, mesh, batch, max_len,
                                                T.uniform_layers(cfg)))
        pre = f"spec/{key}/{shape}/{batch}/{max_len}/"
        want = {k[len(pre):]: str(v) for k, v in ref.items()
                if k.startswith(pre)}
        assert sorted(want) == sorted(specs)
        for k, spec in specs.items():
            got = "|".join(ent(e) for e in spec)
            if k.endswith("state"):
                assert got.split("|")[0] == want[k].split("|")[0], k
                assert set(got.split("|")[1:]) == {""}, k
            else:
                assert got == want[k], (k, got, want[k])
            n += 1
    assert n


def _flat_specs(tree, prefix=""):
    """{path joined with '/': spec} of a tree of dicts and lists whose
    leaves are ``Placement``s."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.spec
    return out


# ------------------------------------------------- one process, no world

def _one_rank_mesh():
    return ProcessMesh(("data", "model"), (1, 1), 0, torch.device("cpu"), {})


@pytest.mark.parametrize("key", ["qwen3", "gemma2", "hymba"])
def test_one_rank_mesh_is_bitwise_one_device(key):
    """A (1, 1) mesh: logits, caches and the engine's tokens bitwise the
    one-device port's."""
    cfg = _cfg(key)
    params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
    mesh = _one_rank_mesh()
    tok = _tokens(cfg, 4)
    shards = SH.cache_placements(cfg, mesh, 4, MAX_LEN)
    got_l, got_c = _decode(params, cfg, tok, MAX_LEN, False, mesh,
                           shards=shards)
    want_l, want_c = _decode(params, cfg, tok, MAX_LEN, False)
    for a, b in zip(got_l, want_l):
        assert torch.equal(a, b)
    for a, b in zip(got_c, want_c):
        fa, fb = M.flatten(a), M.flatten(b)
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    reqs = _requests(cfg)
    one = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu").serve(reqs)
    got = ServeEngine(cfg, params, max_len=MAX_LEN, mesh=mesh).serve(reqs)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.n_prefill, a.n_decoded) == (b.n_prefill, b.n_decoded)


def test_one_rank_scan_forms_match_decode_step():
    """decode_step_scan on stack_caches bitwise decode_step on one
    device; prefill_scan's stacked K/V and last logits bitwise the
    prefill's unrolled ones."""
    cfg = _cfg("qwen3")
    params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
    tok = torch.from_numpy(_tokens(cfg, 4))
    want_l, want_c = _decode(params, cfg, tok.numpy(), MAX_LEN, False)
    with torch.inference_mode():
        _, caches, start = T.prefill(params, tok[:, :PROMPT], cfg, MAX_LEN,
                                     last_logits_only=True)
        stacked = T.stack_caches(caches)
        for i in range(STEPS):
            lg, stacked = T.decode_step_scan(
                params, tok[:, start + i:start + i + 1], stacked, start + i,
                cfg)
            assert torch.equal(lg, want_l[i + 1])
        want = T.stack_caches(want_c)
        for k, v in M.flatten(want).items():
            assert torch.equal(M.flatten(stacked)[k], v), k
        lg, kv = T.prefill_scan(params, tok[:, :PROMPT], cfg)
        _, full, _ = T.prefill(params, tok[:, :PROMPT], cfg, PROMPT)
    assert torch.equal(lg, want_l[0])
    assert torch.equal(kv["k"], torch.stack([c["k"] for c in full]))
    assert set(kv) == {"k", "v"}
    with pytest.raises(ValueError, match="uniform"):
        g = _cfg("gemma2")
        T.decode_step_scan(params, tok[:, :1], stacked, 0, g)


def test_abstract_decode_caches_allocate_nothing():
    cfg = get_config("gemma2-27b")
    caches = T.abstract_decode_caches(cfg, 8, 2080)
    real = T.init_decode_caches(cfg.reduced(), 2, 16, device="cpu")
    assert len(caches) == cfg.n_layers
    assert all(x.device.type == "meta" for c in caches
               for x in M.flatten(c).values())
    assert tuple(caches[0]["k"].shape) == (8, 2080, 16, 128)
    assert set(caches[0]) == set(real[0])


@pytest.mark.parametrize("window", [None, 5])
def test_merge_of_partials_matches_decode_attention(window):
    """The cache split into 4 shards of slots, each attended alone and
    merged: within float32 rounding of ``decode_attention`` over the
    whole cache, with shards that hold no visible slot (empty, or
    outside the window) adding nothing and no NaN anywhere."""
    rng = np.random.default_rng(8)
    b, s, kh, g, d = 2, 16, 2, 3, 8
    q = torch.from_numpy(rng.standard_normal((b, 1, kh * g, d))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    pos = torch.full((b, s), -1, dtype=torch.int32)
    pos[:, 4:10] = torch.arange(4, 10, dtype=torch.int32)   # shard 3 empty
    qpos = 9
    want = L.decode_attention(q, k, v, pos, qpos, window=window, softcap=30.0)
    parts = [L.decode_attention_partial(q, k[:, i:i + 4], v[:, i:i + 4],
                                        pos[:, i:i + 4], qpos, window=window,
                                        softcap=30.0)
             for i in range(0, s, 4)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    assert torch.isinf(m[3]).all() and not l[3].any() and not o[3].any()
    if window == 5:       # positions 4 and below are outside it
        assert torch.isinf(m[0]).all()
    reduce = lambda x, op: (x.amax(0) if op == "max" else x.sum(0)).expand(
        x.shape)
    got = L.merge_partials(m, l, o, reduce)[0]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.reshape(b, 1, kh * g, d), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b_loc", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_moe_capacity_at_decode_matches_reference(b_loc, m):
    """``moe_sharded`` at decode packs ``B_loc x 1`` tokens: the port's
    capacity for them is the reference's for the same local count (its
    ``t_loc`` for a batch that divides its data ranks)."""
    from repro.configs import get_config as jget_config
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    for arch in ("grok-1-314b", "kimi-k2-1t-a32b"):
        n_data = 2
        jc = jget_config(arch)
        b = b_loc * n_data
        t_loc = (b // n_data) * 1 if b >= n_data else b
        assert tmoe.capacity(b_loc * 1, get_config(arch), m) == \
            jmoe.capacity(t_loc, jc, m) == b_loc


def test_mesh_refusals():
    """Over a mesh, prefill, decode and the scan forms need the caches'
    layout for the whole batch, and refuse one that gives this rank
    other rows or another ring; the engine runs on the mesh's device;
    decode_step_scan needs uniform layers."""
    cfg = _cfg("qwen3")
    params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
    mesh = _one_rank_mesh()
    caches = T.init_decode_caches(cfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="cache_shards"):
        T.decode_step(params, tok, caches, 0, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="cache_shards"):
        T.prefill(params, tok, cfg, 8, mesh=mesh)
    with pytest.raises(ValueError, match="cache_shards"):
        T.prefill_scan(params, tok, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="rows"):
        T.prefill(params, torch.zeros((3, 4), dtype=torch.int32), cfg, 8,
                  mesh=mesh, cache_shards=SH.cache_placements(cfg, mesh, 4, 8))
    with pytest.raises(ValueError, match="rows"):
        T.decode_step(params, tok, caches, 0, cfg, mesh=mesh,
                      cache_shards=SH.cache_placements(cfg, mesh, 2, 8))
    with pytest.raises(ValueError, match="slots"):
        T.prefill(params, tok, cfg, 8, mesh=mesh,
                  cache_shards=SH.cache_placements(cfg, mesh, 1, 16))
    with pytest.raises(ValueError, match="slots"):
        T.decode_step(params, tok, caches, 0, cfg, mesh=mesh,
                      cache_shards=SH.cache_placements(cfg, mesh, 1, 16))
    with pytest.raises(ValueError, match="rows"):
        T.prefill_scan(params, torch.zeros((3, 4), dtype=torch.int32), cfg,
                       mesh=mesh, cache_shards=SH.cache_placements(
                           cfg, mesh, 4, 4, stacked=True))
    with pytest.raises(ValueError, match="not the mesh's"):
        ServeEngine(cfg, params, mesh=mesh, device="meta")


@pytest.mark.parametrize("over_mesh", [False, True])
def test_dropped_engine_is_freed_at_once(over_mesh):
    """An engine holds no reference cycle: dropping it frees it (and the
    parameters only it holds) at once, not at the next garbage
    collection, so that a caller serving one large model after another
    does not hold two on the card."""
    import gc
    import weakref

    cfg = _cfg("qwen3")
    params = convert.lm_params_from_numpy(_weights(cfg), cfg, "cpu")
    kw = dict(mesh=_one_rank_mesh()) if over_mesh else dict(device="cpu")
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, **kw)
    eng.serve(_requests(cfg)[:2])
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        gc.enable()
