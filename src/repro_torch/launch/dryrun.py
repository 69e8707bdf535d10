"""Multi-pod dry run: one real step of every (arch x shape x mesh) cell
on ``meta`` tensors, and what that step does.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell with XLA and reads its FLOPs and bytes from ``cost_analysis``,
its memory from ``memory_analysis`` and its collectives from the HLO
text.  The port has no compiled program.  It runs the step a user runs
-- ``train.loop.make_train_step``'s step, ``transformer.prefill_scan``,
``decode_step_scan`` (uniform layers) or ``decode_step`` -- once, as rank
0 of a ``"fake"`` ``torch.distributed`` world of the production mesh's
size (256 ranks for 16x16, 512 for 2x16x16; ``fake_world``), on meta
tensors: every collective returns at once, nothing is allocated, and no
card is needed.  Eager PyTorch fuses nothing, so what the step does is
the port's own work on one rank, not an estimate of it:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
  convolutions; elementwise work is not counted), plus what the kernels'
  meta routes charge (``kernels._lib.META_COSTS``: ``decay_scan`` and its
  backward, which compute nothing on meta tensors);
* bytes accessed: ``StepCounter``, one ``TorchDispatchMode`` that adds
  each op's tensor inputs read and outputs written, leaving out views,
  allocations and collectives, plus the kernels' charged bytes: HBM
  traffic with no cache, as eager PyTorch issues it;
* collectives by kind, count and result bytes: the same mode, at the
  one place every collective passes through, the ``c10d`` operator that
  a ``torch.distributed`` call dispatches to.  ``sharding._gather_dim``
  and ``_scatter_dim`` (FSDP gathers, reduce-scatters), ``Placement.psum``,
  ``all_reduce_``, ``all_gather_dim``, Megatron's f and g, and the
  sequence-split merge ``transformer._seq_reduce`` all reach it;
* memory: the bytes of this rank's arguments and outputs, and the
  persistent state by ``static_capacity_model``.

The step reaches no host sync on meta tensors: the train, prefill and
decode paths hold every scalar as a tensor or a Python int, and
``decay_scan`` takes its meta route.

Keys of the reference with no counterpart are left out:
``cpu_f32_artifact_bytes``, ``live_bytes_tpu_est`` and the ``fits_16GB*``
flags measure XLA:CPU's hoisted converts and a 16 GB TPU v5e
(``fits_80GB``, the capacity model against one H100's 80 GB, takes their
place); ``live_bytes``, ``temp_bytes`` and ``generated_code_bytes`` come
from XLA's buffer assignment, and eager PyTorch has none (no temporaries
are counted); ``lower_s`` / ``compile_s`` become ``step_s``, the host
seconds of the counted step; and ``parse_collectives`` reads HLO text,
which the port does not have.

A dim that does not split over its mesh axes raises in
``sharding.Placement`` where GSPMD would pad it: such a cell is reported
as an ``error:`` that names the leaf, never padded.  A microbatch whose
rows the data ranks do not divide is padded, as GSPMD pads the
reference's: each rank takes a block of ceil(rows / ranks) rows, filled
up with pad rows (``train.loop.make_grad_fn``; gemma2-27b's and
internvl2-26b's ``train_4k`` on 2x16x16, 16 rows over 32 data ranks,
run one row a rank).  The trainer refuses what the reference refuses: a
batch that its microbatches do not divide, and an expert layer's
microbatch that the data ranks do not divide.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun_torch_results
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import warnings
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.hw.constants import H100_SXM
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import Schedule, make_optimizer

#: the ``c10d`` operators that ``torch.distributed`` calls dispatch to,
#: by the reference's collective kinds (a broadcast keeps its own name)
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
}

_A = torch.ops.aten
#: ops that move no bytes: aliases and allocations
_NO_TRAFFIC = {_A._unsafe_view.default, _A.lift_fresh.default,
               _A.empty.memory_format, _A.empty_strided.default,
               _A.empty_like.default, _A.new_empty.default,
               _A.new_empty_strided.default}
#: in-place ops that write their first argument without reading it
_WRITE_ONLY = {_A.fill_.Scalar, _A.fill_.Tensor, _A.zero_.default,
               _A.copy_.default}


# ----------------------------------------------------------------------------
# Meshes with no world, and the fake world
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axes and sizes and no world: all that the sharding rules,
    the placements' shapes and ``static_capacity_model`` read."""

    axes: Tuple[str, ...]
    dims: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.dims))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as ``rank`` of a ``"fake"`` world of ``world_size``
    ranks (``torch.testing``'s fake process group, whose collectives
    return at once), for the block; the world is destroyed after."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process with no world yet")
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes, never allocated)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """An input as the reference's sharded ``ShapeDtypeStruct``: its
    global ``shape``, ``dtype`` and ``spec`` (a ``PartitionSpec`` as a
    tuple) on ``mesh``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    mesh: Any = dataclasses.field(compare=False, repr=False)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        spec = self.spec + (None,) * (len(self.shape) - len(self.spec))
        return SH.Placement(self.shape, spec, self.mesh).local_shape

    def meta(self, local: bool = True) -> torch.Tensor:
        """An empty meta tensor: this rank's block, or the whole."""
        return torch.empty(self.local_shape if local else self.shape,
                           dtype=self.dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """Every model input of this (arch, shape) as a ``Leaf``, the
    decode caches as ``abstract_cache_specs`` gives them."""
    b, s = shape.global_batch, shape.seq_len
    bspec = SH.batch_spec(mesh, b)
    leaf = lambda shp, dt, spec=(): Leaf(tuple(shp), dt, tuple(spec), mesh)
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        s_tok = s - (cfg.frontend_seq if cfg.frontend != "none" else 0)
        out["tokens"] = leaf((b, s_tok), torch.int32, (*bspec, None))
        if shape.kind == "train":
            out["labels"] = leaf((b, s_tok), torch.int32, (*bspec, None))
        if cfg.frontend != "none":
            out["embeds"] = leaf((b, cfg.frontend_seq, cfg.d_model),
                                 cfg.activation_dtype, (*bspec, None, None))
        if shape.kind == "train":
            out["step"] = leaf((), torch.int32)
    else:  # decode
        out["tokens"] = leaf((b, 1), torch.int32, (*bspec, None))
        out["caches"] = abstract_cache_specs(cfg, b, s, mesh)
        out["position"] = leaf((), torch.int32)
    return out


def abstract_cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """The decode caches as this rank's blocks on meta: one stacked tree
    (``decode_step_scan``'s layout) for uniform layers, else a list of
    per-layer trees, laid out by ``sharding.cache_placements``: the KV
    rings' batch over the data axes it divides and their sequence over
    the rest and ``"model"`` (flash-decoding), an SSM's conv rings and
    state over the batch axes.  Unlike the reference's, an SSM state's
    heads stay whole over ``"model"``: the port's SSD block runs whole on
    every rank."""
    stacked = T.uniform_layers(cfg)
    pls = M.flatten(SH.cache_placements(cfg, mesh, batch, max_len,
                                        stacked=stacked))
    caches = T.abstract_decode_caches(cfg, batch, max_len)
    if stacked:
        caches = T.stack_caches(caches)
    return M.unflatten_like(caches, {
        k: torch.empty(pls[k].local_shape, dtype=x.dtype, device="meta")
        for k, x in M.flatten(caches).items()})


def abstract_params(cfg: ModelConfig, mesh):
    """This rank's block of every parameter leaf on meta, in the port's
    float32 masters (the reference's are ``cfg.dtype``)."""
    return M.abstract_params(T.param_defs(cfg), SH.placements(cfg, mesh))


def _optimizer(cfg: ModelConfig, mesh):
    return make_optimizer(cfg.optimizer, Schedule(1e-4),
                          shards=SH.placements(cfg, mesh))


def abstract_opt_state(cfg: ModelConfig, params_abs, mesh):
    """The optimizer state of this rank's blocks ``params_abs`` on meta,
    from the optimizer's own ``init`` (AdamW: float32 moments like each
    block; Adafactor: factored float32 rows and columns where the whole
    leaf is, bf16 momentum)."""
    return _optimizer(cfg, mesh).init(params_abs)


def _nbytes(tree) -> int:
    """Bytes of every tensor in a tree of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


def static_capacity_model(cfg: ModelConfig, shape: ShapeSpec, mesh
                          ) -> Dict[str, float]:
    """Deterministic per-rank capacity model, from ``mesh.shape`` alone
    (an ``AbstractMesh`` will do: no world is needed).

    params / opt_state / kv_cache are summed from this rank's abstract
    blocks; grad_accum is the trainer's accumulator (one per parameter,
    in ``cfg.accum_dtype``, with more than one microbatch); activations
    use the reference's residual formulas.  The port's parameters are
    float32 masters, so ``params`` is twice the reference's for a
    bfloat16 config."""
    out: Dict[str, float] = {}
    params_abs = abstract_params(cfg, mesh)
    out["params"] = _nbytes(params_abs)
    n_data = 1
    for a in SH.data_axes(mesh):
        n_data *= mesh.shape[a]
    if shape.kind == "train":
        out["opt_state"] = _nbytes(abstract_opt_state(cfg, params_abs, mesh))
        acc_b = 2 if cfg.accum_dtype == "bfloat16" else 4
        if cfg.n_microbatches > 1:
            n = sum(x.numel() for x in M.flatten(params_abs).values())
            out["grad_accum"] = n * acc_b
        rows = max(1, shape.global_batch // cfg.n_microbatches // n_data)
        # one bf16 carry a layer (remat keeps each layer's input)
        out["act_carries"] = (cfg.n_layers * rows * shape.seq_len
                              * cfg.d_model * 2)
    else:
        caches = abstract_cache_specs(cfg, shape.global_batch,
                                      shape.seq_len, mesh)
        out["kv_cache"] = _nbytes(caches)
        if shape.kind == "prefill":
            rows = max(1, shape.global_batch // n_data)
            out["act_transient"] = 4 * rows * shape.seq_len * cfg.d_model * 2
    out["total"] = float(sum(out.values()))
    return out


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, "skipped(full-attention)"
    return True, ""


# ----------------------------------------------------------------------------
# The counted step
# ----------------------------------------------------------------------------

class StepCounter(TorchDispatchMode):
    """Adds up, over the ops dispatched inside it, the bytes accessed
    (each op's tensor inputs read and outputs written; views, aliases,
    allocations and collectives left out; ``copy_`` / ``fill_`` /
    ``zero_`` write their first argument without reading it) and the
    collectives, ``{kind: {"count", "bytes"}}``, ``bytes`` the result
    tensors' bytes, as the reference sums the HLO result shapes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(func._schema.name.split("::")[1])
            if kind is not None:
                d = self.collectives.setdefault(kind,
                                                {"count": 0, "bytes": 0.0})
                d["count"] += 1
                d["bytes"] += _nbytes(args[0])
        elif not (func.is_view or func in _NO_TRAFFIC):
            reads = args[1:] if func in _WRITE_ONLY else args
            self.bytes += (_nbytes(list(reads)) + _nbytes(out) + _nbytes(
                [v for k, v in kwargs.items() if k != "out"]))
        return out


def count_step(fn) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn()`` once under the counters: (its output, ``{"flops",
    "bytes", "collectives", "kernels"}``), the kernels' meta routes'
    charges added in and listed."""
    _lib.reset_meta_costs()
    with FlopCounterMode(display=False) as fc, StepCounter() as sc:
        out = fn()
    kernels = {k: dict(v) for k, v in _lib.META_COSTS.items() if v["calls"]}
    return out, {
        "flops": fc.get_total_flops() + sum(v["flops"]
                                            for v in kernels.values()),
        "bytes": sc.bytes + sum(v["bytes"] for v in kernels.values()),
        "collectives": sc.collectives, "kernels": kernels}


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Build one cell's step on meta tensors for this rank of ``mesh``
    (a ``ProcessMesh`` on ``meta``, in a ``fake_world``) and run it once
    under ``count_step``.  Returns ``(counts, {"step_s", "memory"})``.

    train: the trainer's step (``make_train_step``: its microbatches,
    remat, the FSDP gathers and reduce-scatters, the optimizer's update
    in place), handed the whole batch as the port's step takes it;
    prefill: ``prefill_scan`` on this rank's rows, each layer's K/V cut
    to the rank's block of the flash-decoding layout; decode: one
    ``decode_step_scan`` (uniform layers) or ``decode_step`` of this
    rank's rows against its cache blocks, at the last position of a
    ``seq_len`` cache.  (The reference's ``unroll`` and ``donate`` have
    no counterpart: the layers are a Python loop, and the step updates
    its state in place.)"""
    axes = SH.data_axes(mesh)
    params = abstract_params(cfg, mesh)
    ins = input_specs(cfg, shape, mesh)
    emb = ins.get("embeds")
    if shape.kind == "train":
        opt = _optimizer(cfg, mesh)
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh)
        args = (params, state, ins["tokens"].meta(False),
                ins["labels"].meta(False), 0)
        kw = {} if emb is None else {"embeds": emb.meta(False)}
        fn = lambda: step(*args, **kw)
    elif shape.kind == "prefill":
        toks = ins["tokens"].meta()
        e = None if emb is None else emb.meta()
        kvc = None
        if cfg.family != "ssm":
            b, s = shape.global_batch, shape.seq_len
            pl = SH.Placement((b, s, cfg.n_kv_heads, cfg.head_dim),
                              SH.kv_spec(mesh, b, s, 4), mesh)
            kvc = lambda a: SH.local_block(a, pl)
        args = (params, toks, e)

        def fn():
            with torch.no_grad():
                return T.prefill_scan(params, toks, cfg, embeds=e, mesh=mesh,
                                      data_axes=axes, kv_constraint=kvc)
    else:
        b, s = shape.global_batch, shape.seq_len
        uniform = T.uniform_layers(cfg)
        shards = SH.cache_placements(cfg, mesh, b, s, stacked=uniform)
        toks, caches = ins["tokens"].meta(), ins["caches"]
        dec = T.decode_step_scan if uniform else T.decode_step
        args = (params, toks, caches)

        def fn():
            with torch.no_grad():
                return dec(params, toks, caches, s - 1, cfg, mesh=mesh,
                           data_axes=axes, cache_shards=shards)
    t0 = time.perf_counter()
    out, counts = count_step(fn)
    return counts, {"step_s": time.perf_counter() - t0, "memory": {
        "argument_bytes": _nbytes(list(args)),
        "output_bytes": _nbytes(out)}}


def collective_wire_bytes(colls: Dict[str, Dict[str, float]]) -> float:
    """Bytes crossing links per device: AR counts ~2x (ring), others ~1x."""
    total = 0.0
    for kind, d in colls.items():
        mult = 2.0 if kind == "all-reduce" else 1.0
        total += mult * d["bytes"]
    return total


def analyze(counts: Dict[str, Any]) -> Dict[str, Any]:
    """The record keys of a counted step."""
    colls = counts["collectives"]
    return {
        "flops_per_device": float(counts["flops"]),
        "bytes_per_device": float(counts["bytes"]),
        "collectives": colls,
        "collective_bytes_per_device": collective_wire_bytes(colls),
        "kernels": counts["kernels"],
    }


# ----------------------------------------------------------------------------
# Cells and the CLI
# ----------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if not ok:
        rec["status"] = reason
        return rec
    try:
        with fake_world(512 if multi_pod else 256), warnings.catch_warnings():
            # all_gather_into_tensor / reduce_scatter_tensor's renames
            warnings.simplefilter("ignore", FutureWarning)
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            counts, info = lower_cell(cfg, shape, mesh)
            rec.update(info)
            rec.update(analyze(counts))
            rec["status"] = "ok"
            cap = static_capacity_model(cfg, shape, mesh)
            rec["capacity_model"] = cap
            rec["fits_80GB"] = bool(cap["total"] <= H100_SXM.hbm_bytes)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"], default="no")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args()

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in pods:
                t0 = time.time()
                rec = run_cell(a, s, mp)
                rec["wall_s"] = time.time() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (
                        f" flops/dev={rec['flops_per_device']:.3e}"
                        f" bytes/dev={rec['bytes_per_device']:.3e}"
                        f" coll={rec['collective_bytes_per_device']:.3e}B"
                        f" capacity={rec['capacity_model']['total'] / 2**30:.2f}"
                        f"GiB fits80={rec['fits_80GB']}")
                print(f"[{rec['mesh']}] {a} x {s}: {status}{extra} "
                      f"({rec['wall_s']:.1f} s)", flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{a}__{s}__{'mp' if mp else 'sp'}.json"
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(rec, f, indent=1, default=str)


if __name__ == "__main__":
    main()
