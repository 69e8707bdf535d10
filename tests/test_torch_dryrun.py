"""The port's dry run, roofline and report against the reference's, on
the CPU at small size.

* ``model_flops``, ``shape_applicable`` and ``collective_wire_bytes``
  equal the reference's (the last on the reference's own HLO example).
* ``input_specs`` (shapes, dtypes, batch specs, shard shapes) and each
  leaf's shard shape from ``abstract_params`` / ``abstract_opt_state`` /
  ``abstract_cache_specs`` equal the reference's, for reduced qwen3-8b,
  kimi-k2, mamba2, hymba and gemma2 on a (2, 4) mesh; the reference runs
  in a subprocess with 8 host devices (``eval_shape`` only, no compile).
  Two differences are by design and stated: the port's parameters are
  float32 masters (the reference's are bf16: 2x the bytes), and an SSM
  state's heads stay whole over ``"model"`` where the reference splits
  them (the port's SSD block runs whole on every rank).
  ``static_capacity_model`` matches key by key with those factors.
* In a fake world (a subprocess each, since a process group is
  process-global): a reduced dense train step's FLOPs equal the closed
  form of its matmuls; ``corrected_costs`` equals the direct count; a
  train step's all-gather bytes equal the closed form from the
  placements; ``make_production_mesh`` gives the reference's 16x16 and
  2x16x16 shapes on 256 and 512 ranks; a production decode cell runs;
  a reduced gemma2-27b train cell on 2x16x16 whose microbatches hold
  fewer rows than the 32 data ranks runs, padded, and counts the work
  of a cell whose every rank holds one whole row.
* ``decay_scan``'s meta route gives the kernels' shapes and charges, and
  a CPU call stays bitwise its plain version.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import dryrun as RD
from repro.launch import roofline as RR
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun as D
from repro_torch.launch import report
from repro_torch.launch import roofline as R
from repro_torch.models import module as M
from repro_torch.models import transformer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-8b", "kimi-k2-1t-a32b", "mamba2-2.7b", "hymba-1.5b",
         "gemma2-27b")
KINDS = (ShapeSpec("t", 64, 8, "train"), ShapeSpec("p", 64, 8, "prefill"),
         ShapeSpec("d", 64, 8, "decode"))
MESH = D.AbstractMesh(("data", "model"), (2, 4))


def _reduced(get, arch):
    return get(arch).reduced(n_layers=2, n_microbatches=2, dtype="bfloat16",
                             n_experts=4 if get(arch).n_experts else 0)


def _run(script: str) -> dict:
    """Run ``script`` in a fresh Python; its last stdout line, as JSON."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-3000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


# ----------------------------------------------------- no world needed

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_shape_applicable_equal_the_reference(arch):
    for name in SHAPES:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        assert R.model_flops(cfg, SHAPES[name]) == RR.model_flops(
            rcfg, REF_SHAPES[name])
        assert D.shape_applicable(cfg, SHAPES[name]) == RD.shape_applicable(
            rcfg, REF_SHAPES[name])


def test_collective_wire_bytes_equals_the_reference():
    txt = """
  %ar = f32[256,8192]{1,0} all-reduce(%x), replica_groups=...
  %ag.1 = bf16[64,1024]{1,0} all-gather(%y), dimensions={0}
  %foo = f32[2,2]{1,0} add(%a, %b)
"""
    colls = RD.parse_collectives(txt)
    assert D.collective_wire_bytes(colls) == RD.collective_wire_bytes(colls)
    assert D.collective_wire_bytes(colls) == 2 * 256 * 8192 * 4 + 64 * 1024 * 2


def test_roofline_terms_against_the_h100():
    t = R.roofline_terms(989e12, 3.35e12, 0.0, 256)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == 0.0
    t = R.roofline_terms(0.0, 0.0, 450e9, 256)
    assert t["bottleneck"] == "collective" and t["step_time_lb_s"] == 1.0
    # the reference's definition: useful FLOPs at the peak over the bound
    assert R.roofline_fraction(256 * 989e12, 256, 2.0) == pytest.approx(0.5)


def test_report_tables():
    ok = {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
          "flops_per_device": 2e9, "bytes_per_device": 3e9,
          "collective_bytes_per_device": 1e9,
          "capacity_model": {"total": 2 * 2**30}, "fits_80GB": True,
          "compute_s": 1e-3, "memory_s": 2e-3, "collective_s": 0.0,
          "bottleneck": "memory", "model_flops_ratio": 0.5,
          "roofline_fraction": 0.25}
    skip = {"arch": "a", "shape": "l", "mesh": "16x16",
            "status": "skipped(full-attention)"}
    err = {"arch": "b", "shape": "s", "mesh": "16x16", "status": "error: x"}
    dr = report.dryrun_table([ok, skip, err]).splitlines()
    assert dr[2] == "| a | s | 16x16 | ok | 2 | 3.00 | 1.00 | 2.0 | Y |"
    assert "skipped(full-attention)" in dr[3] and "ERROR" in dr[4]
    rf = report.roofline_table([ok, skip, err]).splitlines()
    assert rf[2] == "| a | s | 1.00 | 2.00 | 0.00 | memory | 0.50 | 25.0 |"


@pytest.fixture(scope="module")
def reference_trees():
    """The reference's abstract trees on a (2, 4) mesh of 8 host devices."""
    return _run(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "model"))
    kinds = [ShapeSpec("t", 64, 8, "train"), ShapeSpec("p", 64, 8, "prefill"),
             ShapeSpec("d", 64, 8, "decode")]

    def spec(sh, nd):
        s = list(sh.spec) if sh is not None else []
        s += [None] * (nd - len(s))
        return [None if e is None else [e] if isinstance(e, str) else list(e)
                for e in s]

    def leaves(tree):
        out = {{}}
        for p, x in jax.tree_util.tree_leaves_with_path(tree):
            k = ".".join(str(getattr(q, "key", getattr(q, "idx", q)))
                         for q in p)
            sh = x.sharding
            out[k] = dict(shape=list(x.shape), dtype=str(x.dtype),
                          shard=list(sh.shard_shape(x.shape)) if sh else
                          list(x.shape), spec=spec(sh, len(x.shape)))
        return out

    res = {{}}
    for arch in {list(ARCHS)!r}:
        cfg = get_config(arch).reduced(
            n_layers=2, n_microbatches=2, dtype="bfloat16",
            n_experts=4 if get_config(arch).n_experts else 0)
        r = {{}}
        with mesh:
            p = D.abstract_params(cfg, mesh)
            r["params"] = leaves(p)
            r["opt"] = leaves(D.abstract_opt_state(cfg, p, mesh))
            r["caches"] = leaves(D.abstract_cache_specs(cfg, 8, 64, mesh))
            for sh in kinds:
                ins = D.input_specs(cfg, sh, mesh)
                ins.pop("caches", None)
                r["inputs_" + sh.kind] = leaves(ins)
                r["cap_" + sh.kind] = D.static_capacity_model(cfg, sh, mesh)
        res[arch] = r
    print(json.dumps(res))
    """)


def _norm(spec, nd):
    spec = tuple(spec) + (None,) * (nd - len(spec))
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in spec]


def _dtype(t: torch.dtype) -> str:
    return str(t).replace("torch.", "")


def _state_split(path: str, leaf: dict) -> int:
    """The reference splits an SSM state's heads over "model" where they
    divide it; the port keeps them whole: the factor on that leaf."""
    if path.split(".")[-1] == "state" and ["model"] in leaf["spec"]:
        return MESH.shape["model"]
    return 1


def _opt_shard(ref, path: str):
    """The reference's shard shape of an optimizer-state leaf, but for an
    Adafactor column second moment (``vc``) of a leaf whose last two dims
    are equal: the reference tells ``vr`` from ``vc`` by shape, so there
    it gives ``vc`` the spec of ``vr``; the port places ``vc`` as the
    leaf's spec without its dim -2 (kimi-k2's reduced 64 x 64 shared
    expert)."""
    want = ref["opt"][path]["shard"]
    if path.endswith(".vc"):
        param = ref["params"][path[:-len(".vc")]]
        if param["shape"][-1] == param["shape"][-2]:
            want = param["shard"][:-2] + param["shard"][-1:]
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_the_reference(arch, reference_trees):
    ref = reference_trees[arch]
    cfg = _reduced(get_config, arch)
    for sh in KINDS:
        ins = D.input_specs(cfg, sh, MESH)
        ins.pop("caches", None)
        want = ref["inputs_" + sh.kind]
        assert set(ins) == set(want)
        for k, leaf in ins.items():
            w = want[k]
            assert list(leaf.shape) == w["shape"], (arch, k)
            assert _dtype(leaf.dtype) == w["dtype"], (arch, k)
            assert _norm(leaf.spec, len(leaf.shape)) == w["spec"], (arch, k)
            assert list(leaf.local_shape) == w["shard"], (arch, k)
    params = D.abstract_params(cfg, MESH)
    got = M.flatten(params)
    assert set(got) == set(ref["params"])
    for k, x in got.items():
        # the port's float32 masters, the reference's bf16 parameters
        assert x.device.type == "meta" and x.dtype == torch.float32
        assert ref["params"][k]["dtype"] == "bfloat16"
        assert list(x.shape) == ref["params"][k]["shard"], (arch, k)
    opt = M.flatten(D.abstract_opt_state(cfg, params, MESH))
    assert set(opt) == set(ref["opt"])
    for k, x in opt.items():
        assert list(x.shape) == _opt_shard(ref, k), (arch, k)
        assert _dtype(x.dtype) == ref["opt"][k]["dtype"], (arch, k)
    caches = M.flatten(D.abstract_cache_specs(cfg, 8, 64, MESH))
    assert set(caches) == set(ref["caches"])
    for k, x in caches.items():
        w = ref["caches"][k]
        f = _state_split(k, w)
        want = [n * f if e == ["model"] else n
                for n, e in zip(w["shard"], w["spec"])] if f > 1 else w["shard"]
        assert list(x.shape) == want, (arch, k)
        assert _dtype(x.dtype) == w["dtype"], (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_capacity_model_matches_the_reference(arch, reference_trees):
    """Key by key: ``params`` is 2x (float32 masters against bf16),
    ``kv_cache`` holds each SSM state ``model`` times where the reference
    splits its heads, and ``opt_state`` sums ``_opt_shard``'s shapes;
    every other key is equal."""
    ref = reference_trees[arch]
    cfg = _reduced(get_config, arch)
    state_extra = sum(
        (_state_split(k, w) - 1) * math.prod(w["shard"])
        * (4 if w["dtype"] == "float32" else 2)
        for k, w in ref["caches"].items())
    for sh in KINDS:
        got = D.static_capacity_model(cfg, sh, MESH)
        want = dict(ref["cap_" + sh.kind])
        want["params"] *= 2
        if "opt_state" in want:
            want["opt_state"] = sum(
                math.prod(_opt_shard(ref, k))
                * (4 if w["dtype"] == "float32" else 2)
                for k, w in ref["opt"].items())
        if "kv_cache" in want:
            want["kv_cache"] += state_extra
        want["total"] = float(sum(v for k, v in want.items() if k != "total"))
        assert got == want, (arch, sh.kind)


# ------------------------------------------------ the decay_scan routes

def test_decay_scan_meta_route_charges_the_kernels():
    b, t, c = 3, 5, 7
    a = torch.empty((b, t, c), device="meta", requires_grad=True)
    x = torch.empty((b, t, c), device="meta", requires_grad=True)
    s0 = torch.empty((b, c), device="meta")
    _lib.reset_meta_costs()
    launches = dict(_lib.LAUNCHES)
    st, fin = ops.decay_scan(a, x, s0)
    assert st.shape == (b, t, c) and fin.shape == (b, c)
    assert st.dtype == fin.dtype == torch.float32 and st.device.type == "meta"
    assert _lib.META_COSTS["decay_scan"] == {
        "calls": 1, "flops": 2 * b * t * c,
        "bytes": 4 * (3 * b * t * c + 2 * b * c)}
    da, dx = torch.autograd.grad(st.sum(), (a, x))
    assert da.shape == dx.shape == (b, t, c) and da.device.type == "meta"
    assert _lib.META_COSTS["decay_scan_bwd"] == {
        "calls": 1, "flops": 3 * b * t * c,
        "bytes": 4 * (5 * b * t * c + 2 * b * c)}
    assert _lib.LAUNCHES == launches   # a meta call launches nothing
    _lib.reset_meta_costs()


def test_decay_scan_cpu_stays_its_plain_version():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(np.exp(-rng.random((2, 9, 5))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    for got, want in zip(ops.decay_scan(a, x, s0),
                         kref.decay_scan_ref(a, x, s0)):
        assert torch.equal(got, want)
    assert _lib.META_COSTS["decay_scan"]["calls"] == 0


# ------------------------------------------------------- fake worlds

@pytest.fixture(scope="module")
def fake_counts():
    return _run("""
    import dataclasses, json, warnings
    warnings.simplefilter("ignore", FutureWarning)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    out = {}
    for n, mp in ((256, False), (512, True)):
        with D.fake_world(n, rank=n - 1):
            out[f"mesh_{n}"] = make_production_mesh(
                multi_pod=mp, device="meta").shape
    kinds = [ShapeSpec("t", 64, 8, "train"), ShapeSpec("p", 64, 8, "prefill"),
             ShapeSpec("d", 64, 8, "decode")]
    with D.fake_world(1):
        mesh = make_test_mesh((1, 1), device="meta")
        for arch in ("qwen3-8b", "gemma2-27b"):
            cfg = get_config(arch).reduced(n_layers=2, n_microbatches=2,
                                           dtype="bfloat16")
            for sh in kinds[:2] if arch == "gemma2-27b" else kinds:
                counts, _ = D.lower_cell(cfg, sh, mesh)
                out[f"direct_{arch}_{sh.kind}"] = R._costs(D.analyze(counts))
                out[f"probe_{arch}_{sh.kind}"] = R.corrected_costs(cfg, sh,
                                                                   mesh)
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(
        n_layers=2, n_microbatches=2, dtype="bfloat16"), fsdp=True)
    with D.fake_world(8, rank=5):
        mesh = make_test_mesh((2, 4), device="meta")
        counts, _ = D.lower_cell(cfg, kinds[0], mesh)
        out["train_collectives"] = counts["collectives"]
    rec = D.run_cell("gemma2-27b", "decode_32k", False)
    rec.pop("traceback", None)
    out["cell"] = rec
    # 8 and 32 rows a microbatch over the 32 data ranks of 2x16x16
    D.get_config = lambda arch: get_config(arch).reduced(
        n_layers=2, n_microbatches=2, dtype="bfloat16")
    for batch in (16, 64):
        D.SHAPES = {"train_4k": ShapeSpec("train_4k", 64, batch, "train")}
        rec = D.run_cell("gemma2-27b", "train_4k", True)
        rec.pop("traceback", None)
        out[f"padded_{batch}"] = rec
    print(json.dumps(out))
    """)


def test_production_meshes_on_fake_worlds(fake_counts):
    assert fake_counts["mesh_256"] == {"data": 16, "model": 16}
    assert fake_counts["mesh_512"] == {"pod": 2, "data": 16, "model": 16}


def test_train_flops_equal_the_closed_form_of_the_matmuls(fake_counts):
    """One rank, reduced qwen3-8b, 8 x 64 tokens: each layer's matmuls
    run forward, again under remat and twice in the backward (4x), the
    unembedding's forward and backward (3x); the attention of a 64-token
    sequence is one full 64 x 64 tile."""
    cfg = _reduced(get_config, "qwen3-8b")
    b, s = 8, 64
    d, h, k, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.d_ff)
    per_token = 2 * d * (h + 2 * k) * hd + 2 * h * hd * d + 3 * 2 * d * f
    attn = 2 * (2 * h * s * s * hd)
    layers = cfg.n_layers * (b * s * per_token + b * attn)
    head = b * s * 2 * d * T.padded_vocab(cfg)
    assert fake_counts["direct_qwen3-8b_train"]["flops"] == 4 * layers + 3 * head


@pytest.mark.parametrize("cell", ["qwen3-8b_train", "qwen3-8b_prefill",
                                  "qwen3-8b_decode", "gemma2-27b_train",
                                  "gemma2-27b_prefill"])
def test_corrected_costs_equal_the_direct_count(fake_counts, cell):
    """Nothing is counted once per scan in an eager step: the probes'
    FLOPs are the direct count's.  Bytes and collectives agree too,
    except in a train step, where the probe's one microbatch also counts
    the once-a-step optimizer update and data sums ``mult`` times."""
    direct, probe = fake_counts["direct_" + cell], fake_counts["probe_" + cell]
    assert probe["flops"] == direct["flops"]
    if not cell.endswith("train"):
        assert probe == direct


def test_train_all_gather_bytes_equal_the_placements(fake_counts):
    """FSDP over the data axis of a (2, 4) mesh: each microbatch gathers
    each layer leaf split over "data" twice (its forward and its remat
    recompute) and each top-level one once; an all-gather's bytes are its
    result's, the block with its data dims whole (float32)."""
    cfg = dataclasses.replace(_reduced(get_config, "qwen3-8b"), fsdp=True)
    pls = M.flatten(SH.placements(cfg, MESH))
    n_data = MESH.shape["data"]
    count = nbytes = 0
    for path, pl in pls.items():
        split = [i for i, e in enumerate(pl.spec)
                 if e is not None and "data" in ((e,) if isinstance(e, str)
                                                 else e)]
        if not split:
            continue
        shape = list(pl.local_shape)
        for i in split:
            shape[i] *= n_data
        if path.startswith("layers."):
            times = 2 * cfg.n_layers
            shape = shape[1:]
        else:
            times = 1 + (path == "embed" and cfg.tie_embeddings)
        count += times
        nbytes += times * 4 * math.prod(shape)
    ag = fake_counts["train_collectives"]["all-gather"]
    assert ag == {"count": cfg.n_microbatches * count,
                  "bytes": float(cfg.n_microbatches * nbytes)}
    assert fake_counts["train_collectives"]["reduce-scatter"]["count"] > 0


def test_a_production_decode_cell_runs(fake_counts):
    rec = fake_counts["cell"]
    assert rec["status"] == "ok", rec["status"]
    assert rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["capacity_model"]["kv_cache"] > 0 and rec["fits_80GB"]
    skipped = D.run_cell("qwen3-8b", "long_500k", False)
    assert skipped["status"] == "skipped(full-attention)"


def test_a_padded_train_cell_runs(fake_counts):
    """gemma2-27b's ``train_4k`` on 2x16x16 in small: 16 rows in 2
    microbatches over 32 data ranks, so each rank's block is one row,
    real on ranks 0-7 and padding elsewhere (rank 0 holds a real one).
    The cell is ``ok``, and its rank does the FLOPs and collectives of
    a batch of 64, whose every rank holds one whole row; its bytes add
    only the pad rows' copies and the row weights' product."""
    rec, even = fake_counts["padded_16"], fake_counts["padded_64"]
    assert rec["status"] == "ok", rec["status"]
    assert even["status"] == "ok", even["status"]
    assert rec["mesh"] == "2x16x16"
    for k in ("flops_per_device", "collective_bytes_per_device"):
        assert rec[k] == even[k] > 0, k
    assert rec["collectives"] == even["collectives"]
    extra = rec["bytes_per_device"] - even["bytes_per_device"]
    assert 0 < extra < 1e-4 * even["bytes_per_device"], extra
