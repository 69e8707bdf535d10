"""repro_torch's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``;
they are marked ``gpu`` and skip inside the ``cuda`` fixture where there
is no card.  Run them on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Bands: ``ts_decay`` reads and masks bitwise the plain version's on the
same device (both IEEE float32 with the same ``expf``; the kernel's
corrected-reciprocal division is gated bitwise against ``__fdiv_rn`` over
every dividend of the repo's taus and 2^32 random triples), support
counts exact away from the threshold (and the fused support bitwise
equal to the mask form's on the kernel's own mask), scatter results and
``decay_scan`` bitwise (one IEEE product and one IEEE sum per step on both
sides).  The reduced Mamba-2 LM on the card sits within rtol = 1e-4,
atol = 1e-4 x max(1, max|CPU|) of the CPU port in float32: the two
devices sum inside their matrix products in other orders and evaluate
``exp`` with other routines.  Analog reads on the card sit within 8 ULP
of the CPU port (the noise is drawn on each device: the same threefry
bits, CUDA's ``log1p``/``sqrt`` in the normal; 8 is the CPU tests'
analog_2d band), comparator products equal away from V_tw; the ring push
and the stream's digests are bitwise.  The training path (UNet, SSIM,
gradients, AdamW / Adafactor) on the card sits within the CPU tests'
bands of the CPU port (``tests/test_torch_unet.py``,
``tests/test_torch_optimizer.py``): forward rtol = atol = 1e-4 x
max(1, max|CPU|), gradients 1e-4 x each leaf's max, one update 3 ULP of
the larger operand plus 1e-5 of a step, with cuDNN's TF32 left at
PyTorch's default (on): the port's float32 rule holds the backward too.
"""
import pytest
import torch

from repro_torch.core import edram, prng
from repro_torch.core import time_surface as ts
from repro_torch.events import aer, datasets
from repro_torch.kernels import _lib, ops, ref
from repro_torch.serve import spec as rs
from repro_torch.serve import ts_engine as eng

pytestmark = pytest.mark.gpu

SHAPE = (4, 2, 60, 100)
T_NOW = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    return torch.device("cuda")


def _sae(device, seed=0, shape=SHAPE):
    g = torch.Generator().manual_seed(seed)
    sae = torch.rand(shape, generator=g) * T_NOW
    sae[torch.rand(shape, generator=g) < 0.3] = float("-inf")
    return sae.to(device)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _near(v, v_tw, radius):
    near = ref.ulp_distance(v, torch.full_like(v, v_tw)) <= 4
    return ref.stcf_support_ref(near, radius, include_self=True) > 0


@pytest.mark.parametrize("offset", [0, 1])   # float4 path, then unaligned
def test_ts_decay_matches_plain(cuda, offset):
    p = edram.decay_params_for_cmem()
    v_tw = edram.v_tw_for_window(0.024, p)
    sae = _sae(cuda).flatten()[offset:offset + 40001]
    before = _lib.LAUNCHES["ts_decay"]
    v, m = ops.ts_decay_with_mask(sae, T_NOW, p, v_tw)
    vr, mr = ref.ts_decay_ref(sae, T_NOW, p, v_tw)
    assert _lib.LAUNCHES["ts_decay"] == before + 1
    assert _same(v, vr)
    assert torch.equal(m, mr)
    assert torch.equal(ops.ts_decay(sae, T_NOW, p), v)


def test_ts_decay_planes_matches_plain(cuda):
    base = edram.decay_params_for_cmem()
    g = torch.Generator().manual_seed(1)
    hw = SHAPE[-2:]
    eps = 1.0 + 0.05 * torch.randn((2,) + hw, generator=g)
    planes = edram.DecayParams(
        torch.full(hw, float(base.a1)), float(base.tau1) / eps[0],
        torch.full(hw, float(base.a2)), float(base.tau2) / eps[1],
        torch.full(hw, float(base.b)))
    planes = edram.DecayParams(*(x.float().to(cuda) for x in planes))
    sae = _sae(cuda, 2)
    v = ops.ts_decay(sae, T_NOW, planes)
    assert _same(v, ref.ts_decay_ref(sae, T_NOW, planes))


@pytest.mark.parametrize("hw", [(1, 1), (37, 61), (5, 1001), (16, 20)])
@pytest.mark.parametrize("lead", [1, 3, 128])
@pytest.mark.parametrize("offset", [0, 4])   # aligned, then 16 B off
def test_ts_decay_planes_ragged_shapes_match_plain(cuda, hw, lead, offset):
    """The plane form at planes whose length is not a multiple of 4 (1,
    2257, 5005 cells: the scalar path) and one that is (320: float4
    columns, or the scalar path where the tensors sit 4 floats off a
    16-byte boundary), under 1, 3 and 128 leading planes, with and
    without the comparator: bitwise the plain version."""
    g = torch.Generator().manual_seed(lead * 7 + hw[0])
    base = edram.decay_params_for_cmem()
    v_tw = edram.v_tw_for_window(0.024, base)
    eps = 1.0 + 0.05 * torch.randn((2,) + hw, generator=g)

    def place(x):   # contiguous, ``offset`` floats into its buffer
        buf = torch.zeros(x.numel() + offset, dtype=torch.float32)
        buf[offset:] = x.flatten()
        return buf.to(cuda)[offset:].view(x.shape)

    planes = edram.DecayParams(*(place(x.float()) for x in (
        torch.full(hw, float(base.a1)), float(base.tau1) / eps[0],
        torch.full(hw, float(base.a2)), float(base.tau2) / eps[1],
        torch.full(hw, float(base.b)))))
    sae = place(_sae("cpu", 11, (lead,) + hw))
    v, m = ops.ts_decay_with_mask(sae, T_NOW, planes, v_tw)
    vr, mr = ref.ts_decay_ref(sae, T_NOW, planes, v_tw)
    assert _same(v, vr)
    assert torch.equal(m, mr)
    assert _same(ops.ts_decay(sae, T_NOW, planes), vr)


def test_decay_division_gate(cuda):
    """decay.cuh's corrected-reciprocal quotient against __fdiv_rn: 0
    decay values and 0 quotients differ over all 2^32 dividend bit
    patterns of each gated tau (the uniform form's host reciprocal) and
    over 2^32 random (dividend, tau1, tau2) triples (clamped at 1e-9 s,
    reciprocals taken on the card)."""
    from repro_torch.kernels.ts_decay import division_gate, gate_taus

    for tau in gate_taus():
        assert division_gate(cuda, tau) == (0, 0), tau
    assert division_gate(cuda, seed=17) == (0, 0)


@pytest.mark.parametrize("radius", [0, 1, 3, 7, 16])
@pytest.mark.parametrize("include_self", [False, True])
def test_stcf_support_matches_plain(cuda, radius, include_self):
    p = edram.decay_params_for_cmem()
    v_tw = edram.v_tw_for_window(0.024, p)
    sae = _sae(cuda, 3)
    fused = ops.stcf_support_fused(sae, p, v_tw, T_NOW, radius, include_self)
    _, m = ops.ts_decay_with_mask(sae, T_NOW, p, v_tw)
    assert torch.equal(fused, ops.stcf_support(m, radius, include_self))
    plain = ref.stcf_support_fused_ref(sae, radius, p, v_tw, T_NOW,
                                       include_self)
    far = ~_near(ref.ts_decay_ref(sae, T_NOW, p), v_tw, radius)
    assert torch.equal(fused[far], plain[far])
    assert torch.equal(ops.stcf_support(m, radius, include_self),
                       ref.stcf_support_ref(m, radius, include_self))


@pytest.mark.parametrize("shape", [(3, 37, 61), (2, 240, 320), (1, 5, 1000),
                                   (2, 45, 20), (1, 70, 1601)])
@pytest.mark.parametrize("radius", [0, 1, 3, 7, 16])
@pytest.mark.parametrize("include_self", [False, True])
def test_stcf_support_ragged_shapes_match_plain(cuda, shape, radius,
                                                include_self):
    """Both forms at ragged planes: H not a multiple of a band, a plane
    narrower than one 32-column word, planes wider than one block's span
    (1000 and 1601 columns), every radius."""
    p = edram.decay_params_for_cmem()
    v_tw = edram.v_tw_for_window(0.024, p)
    sae = _sae(cuda, 9, shape)
    fused = ops.stcf_support_fused(sae, p, v_tw, T_NOW, radius, include_self)
    _, m = ops.ts_decay_with_mask(sae, T_NOW, p, v_tw)
    mask_form = ops.stcf_support(m, radius, include_self)
    assert torch.equal(fused, mask_form)
    assert torch.equal(mask_form, ref.stcf_support_ref(m, radius,
                                                       include_self))
    plain = ref.stcf_support_fused_ref(sae, radius, p, v_tw, T_NOW,
                                       include_self)
    far = ~_near(ref.ts_decay_ref(sae, T_NOW, p), v_tw, radius)
    assert torch.equal(fused[far], plain[far])


def _pool(device, s, p, h, w, block, seed):
    _, _, tpl = ops.tile_geometry(h, w, block)
    g = torch.Generator().manual_seed(seed)
    return (_sae(device, seed, (s, p, h, w)),
            (torch.rand((s, p * tpl), generator=g) < 0.2).to(device),
            torch.randint(0, 5, (s, h, w), generator=g,
                          dtype=torch.int32).to(device),
            torch.rand(s, generator=g).to(device) * T_NOW,
            torch.randint(0, 100, (s,), generator=g,
                          dtype=torch.int32).to(device))


@pytest.mark.parametrize("polarities", [2, 1])
@pytest.mark.parametrize("n, offset", [(5000, 0), (5001, 0), (5000, 1)])
def test_chunk_scatter_duplicate_heavy_matches_plain(cuda, polarities, n,
                                                     offset):
    """Rows of 5,000+ events (three segments), 90 % of the events on 8
    cells, equal stamps inside a run, four rows aimed at one slot, rows
    aimed outside the pool, x, y and p out of range; P = 1 merges
    polarity.  Aligned vector loads (n = 5000), then the scalar path (an
    odd n, and fields one element off 16-byte alignment).  All five
    outputs bitwise."""
    s, h, w, block = 6, 60, 100, (8, 128)
    g = torch.Generator().manual_seed(10)
    b = 9

    def ints(lo, hi):
        return torch.randint(lo, hi, (b, n), generator=g, dtype=torch.int32)

    hot = torch.randint(0, 8, (b, n), generator=g)
    hx, hy = torch.randint(0, w, (8,), generator=g), torch.randint(0, h, (8,),
                                                                  generator=g)
    is_hot = torch.rand((b, n), generator=g) < 0.9
    fields = dict(
        x=torch.where(is_hot, hx[hot].int(), ints(-3, w + 3)),
        y=torch.where(is_hot, hy[hot].int(), ints(-3, h + 3)),
        t=(ints(0, 500).float() * 1e-4 - 0.01),
        p=ints(-1, polarities + 1),
        valid=torch.rand((b, n), generator=g) < 0.9)

    def place(f):   # a contiguous (b, n) view ``offset`` elements in
        buf = torch.zeros(b * n + offset, dtype=f.dtype)
        buf[offset:] = f.flatten()
        return buf.to(cuda)[offset:].view(b, n)

    ev = ts.EventBatch(**{k: place(v) for k, v in fields.items()})
    sids = torch.tensor([2, 2, 2, 2, 5, -1, s, 0, 3], dtype=torch.int32,
                        device=cuda)
    outs = []
    for fn in (ops.chunk_scatter_, ref.chunk_scatter_ref):
        st = _pool(cuda, s, polarities, h, w, block, 11)
        fn(st[0], sids, ev, st[1], block, st[2], st[3], st[4])
        outs.append(st)
    for a, b_ in zip(*outs):
        if a.dtype == torch.float32:
            a, b_ = a.view(torch.int32), b_.view(torch.int32)
        assert torch.equal(a, b_)
    # and with no dirty marks or counter plane
    outs = []
    for fn in (ops.chunk_scatter_, ref.chunk_scatter_ref):
        st = _pool(cuda, s, polarities, h, w, block, 12)
        fn(st[0], sids, ev, None, block, None, st[3], st[4])
        outs.append((st[0].view(torch.int32), st[3].view(torch.int32), st[4]))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_chunk_scatter_matches_plain(cuda):
    s, p, h, w, block = SHAPE + ((8, 128),)
    g = torch.Generator().manual_seed(4)
    b, n = 37, 500
    ev = ts.EventBatch(
        x=torch.randint(-3, w + 3, (b, n), generator=g, dtype=torch.int32),
        y=torch.randint(-3, h + 3, (b, n), generator=g, dtype=torch.int32),
        t=torch.rand((b, n), generator=g) * 0.2 - 0.05,
        p=torch.randint(-1, p + 1, (b, n), generator=g, dtype=torch.int32),
        valid=torch.rand((b, n), generator=g) < 0.9).to(cuda)
    sids = torch.randint(-1, s + 1, (b,), generator=g,
                         dtype=torch.int32).to(cuda)
    _, _, tpl = ops.tile_geometry(h, w, block)
    outs = []
    for fn in (ops.chunk_scatter_, ref.chunk_scatter_ref):
        st = (_sae(cuda, 5), torch.zeros((s, p * tpl), dtype=torch.bool,
                                         device=cuda),
              torch.zeros((s, h, w), dtype=torch.int32, device=cuda),
              torch.zeros(s, device=cuda),
              torch.zeros(s, dtype=torch.int32, device=cuda))
        fn(st[0], sids, ev, st[1], block, st[2], st[3], st[4])
        outs.append(st)
    for a, b_ in zip(*outs):
        if a.dtype == torch.float32:
            a, b_ = a.view(torch.int32), b_.view(torch.int32)
        assert torch.equal(a, b_)


def test_engine_on_card_matches_cpu_port(cuda):
    cfg = eng.TSEngineConfig(h=60, w=100, polarities=2, n_slots=4,
                             chunk_capacity=256, specs=(
                                 rs.ReadoutSpec(count=rs.Count(4)),))
    gpu, cpu = eng.TimeSurfaceEngine(cfg), eng.TimeSurfaceEngine(cfg, "cpu")
    for e in (gpu, cpu):
        for _ in range(cfg.n_slots):
            e.attach()
    items = [(k, aer.pack(datasets.dnd21_like(
        ("driving", "hotel_bar")[k % 2], 60, 100, 0.05, seed=k)))
        for k in range(cfg.n_slots)]
    _lib.reset_launches()
    gpu.push(items)
    cpu.push(items)
    for a, b in ((gpu.state.surfaces.sae, cpu.state.surfaces.sae),
                 (gpu.state.surfaces.t_last, cpu.state.surfaces.t_last)):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    for a, b in ((gpu.state.surfaces.n_events, cpu.state.surfaces.n_events),
                 (gpu.state.counts, cpu.state.counts),
                 (gpu.state.cache.dirty, cpu.state.cache.dirty)):
        assert torch.equal(a.cpu(), b)
    spec = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                          stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    out = gpu.serve_step([], spec, 0.05)
    assert all(_lib.LAUNCHES[k] > 0 for k in
               ("ts_decay", "stcf_support", "chunk_scatter")), _lib.LAUNCHES
    dense = gpu.read(rs.SURFACE_SPEC, 0.05)["surface"]
    assert torch.equal(out["surface"].view(torch.int32),
                       dense.view(torch.int32))


@pytest.mark.parametrize("c", [1001, 1024])       # scalar path, float4 path
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("offset", [0, 1])        # aligned, then not
def test_decay_scan_matches_plain(cuda, c, with_s0, offset):
    g = torch.Generator().manual_seed(6)
    b, t = 3, 19
    a = torch.exp(-0.3 * torch.rand((b * t * c + offset,), generator=g))
    x = torch.randn((b * t * c + offset,), generator=g)
    a, x = (v.to(cuda)[offset:].view(b, t, c) for v in (a, x))
    s0 = torch.randn((b, c), generator=g).to(cuda) if with_s0 else None
    before = _lib.LAUNCHES["decay_scan"]
    st, fin = ops.decay_scan(a, x, s0)
    assert _lib.LAUNCHES["decay_scan"] == before + 1
    st_r, fin_r = ref.decay_scan_ref(a, x, s0)
    torch.cuda.synchronize()
    assert torch.equal(st.view(torch.int32), st_r.view(torch.int32))
    assert torch.equal(fin.view(torch.int32), fin_r.view(torch.int32))
    assert torch.equal(fin, st[:, -1])


def test_init_params_on_card_matches_cpu(cuda):
    """The reduced LM's weights drawn on the card: the per-leaf keys are
    the CPU's bitwise, every weight within prng.normal's 4 ULP (CUDA's
    ``log1p``/``sqrt``), drawn in slices or whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    defs = T.param_defs(get_config("mamba2-2.7b").reduced())
    cpu = M.flatten(M.init_params(defs, prng.PRNGKey(3), "cpu"))
    card = M.flatten(M.init_params(defs, prng.PRNGKey(3), cuda))
    assert torch.equal(prng.split(prng.PRNGKey(3, cuda), len(cpu)).cpu(),
                       prng.split(prng.PRNGKey(3), len(cpu)))
    for k, v in cpu.items():
        assert card[k].device.type == "cuda"
        assert int(ref.ulp_distance(card[k].cpu(), v).max()) <= 4, k


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-4b"])
def test_reduced_dense_lm_on_card_matches_cpu_port(cuda, arch):
    """The dense family at ``reduced()`` (gemma3-4b at 6 layers) on the
    card against the CPU port: a prefill past the window of 32 (the local
    rings wrap) and 6 decode steps, logits and caches in the band of
    ``test_reduced_lm_on_card_matches_cpu_port``, positions bitwise, and
    none of the port's kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced(
        **({"n_layers": 6} if arch == "gemma3-4b" else {}))
    cpu = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), "cpu")
    # attention projections at their true fan-in, as chip_smoke.dense_check
    # scales them (at the initialiser's the softmax is one-hot)
    attn = cpu["layers"]["attn"]
    for w, ref_fan, fan in (("wq", cfg.n_heads, cfg.d_model),
                            ("wk", cfg.n_kv_heads, cfg.d_model),
                            ("wv", cfg.n_kv_heads, cfg.d_model),
                            ("wo", cfg.head_dim, cfg.n_heads * cfg.head_dim)):
        attn[w].mul_((ref_fan / fan) ** 0.5)
    card = M.unflatten({k: v.to(cuda) for k, v in M.flatten(cpu).items()})
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (3, 46), generator=g)

    def close(a, b):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * scale)

    _lib.reset_launches()
    with torch.inference_mode():
        lg, cg, pos = T.prefill(card, tokens[:, :40].to(cuda), cfg, 48)
        lc, cc, _ = T.prefill(cpu, tokens[:, :40], cfg, 48)
        close(lg, lc)
        for i in range(40, 46):
            lg, cg = T.decode_step(card, tokens[:, i:i + 1].to(cuda), cg, i,
                                   cfg)
            lc, cc = T.decode_step(cpu, tokens[:, i:i + 1], cc, i, cfg)
            close(lg, lc)
    for a, b in zip(cg, cc):
        assert torch.equal(a["pos"].cpu(), b["pos"])
        close(a["k"], b["k"])
        close(a["v"], b["v"])
    assert not any(_lib.LAUNCHES.values())


def test_reduced_lm_on_card_matches_cpu_port(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-2.7b").reduced()
    cpu = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), "cpu")
    card = M.unflatten({k: v.to(cuda) for k, v in M.flatten(cpu).items()})
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (3, 45), generator=g)
    _lib.reset_launches()
    with torch.inference_mode():
        lg, cg, _ = T.prefill(card, tokens.to(cuda), cfg, 64)
        assert _lib.LAUNCHES["decay_scan"] == cfg.n_layers
        lc, cc, _ = T.prefill(cpu, tokens, cfg, 64)
    def close(a, b):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * scale)

    close(lg, lc)
    for a, b in zip(cg, cc):
        for k, v in M.flatten(a).items():
            close(v, M.flatten(b)[k])
    prompts = [tokens[i, : 45 - 9 * i].numpy() for i in range(3)]
    reqs = [Request(p, max_new_tokens=5) for p in prompts]
    got = ServeEngine(cfg, card, 64).serve(reqs)
    want = ServeEngine(cfg, cpu, 64, device="cpu").serve(reqs)
    for a, b in zip(got, want):
        assert (a.tokens == b.tokens).all()


def _served_steps(engine, batches, budget, T):
    """Each batch of ``batches`` (lists of prompts) served in turn under
    ``tracing.on()``, with ``T.decode_step`` recording every step: its
    logits copied and how its ``graphs`` ran it (None without them).
    Returns, a call each, (tokens, [(how, logits)], decode spans'
    ``graph`` counts)."""
    from repro_torch import tracing
    from repro_torch.serve.engine import Request

    step, log, out = T.decode_step, [], []

    def recording(*a, **kw):
        r = step(*a, **kw)
        g = kw.get("graphs")
        log.append((g.last if g is not None else None, r[0].clone()))
        return r
    T.decode_step = recording
    try:
        for prompts in batches:
            tracing.clear()
            with tracing.on():
                res = engine.serve([Request(p, max_new_tokens=budget)
                                    for p in prompts])
            counts = [r.counts["graph"] for r in tracing.spans()
                      if r.name == "repro_torch.serve.decode_step"]
            out.append(([r.tokens.tolist() for r in res], list(log), counts))
            log.clear()
    finally:
        T.decode_step = step
        tracing.clear()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_lm_decode_graphs_match_eager_on_card(cuda, dtype):
    """An all-SSM engine on the card decodes over its own two cache sets:
    the first step each way eager, the second captured, the rest
    replayed, and again at a new batch size.  Three calls (3 rows, 3
    again, then 2) give tokens and every step's logits bitwise those of
    the same engine whose ``decode_step`` runs without its graphs (eager,
    new caches each step).  The reduced hybrid gets no graphs, counts
    ``graph`` 0, and serves the tokens of its plain prefill and steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              dtype=dtype)
    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), cuda)
    g = torch.Generator().manual_seed(7)
    tok = lambda n: torch.randint(1, cfg.vocab, (n,), generator=g).numpy()
    three = [tok(n) for n in (45, 36, 27)]
    batches = [three, three, [tok(n) for n in (30, 41)]]
    graphed = _served_steps(ServeEngine(cfg, params, 64), batches, 8, T)

    step = T.decode_step
    without = lambda *a, graphs=None, **kw: step(*a, **kw)
    T.decode_step = without
    try:
        eager = _served_steps(ServeEngine(cfg, params, 64), batches, 8, T)
    finally:
        T.decode_step = step
    first = ["eager", "eager", "capture", "capture", "replay", "replay",
             "replay"]
    assert [[how for how, _ in c[1]] for c in graphed] == [
        first, ["replay"] * 7, first]
    assert [c[2] for c in graphed] == [[0, 0, 1, 1, 1, 1, 1], [1] * 7,
                                       [0, 0, 1, 1, 1, 1, 1]]
    for (gt, gl, _), (et, el, ecounts) in zip(graphed, eager):
        assert gt == et
        assert all(how is None for how, _ in el) and ecounts == [0] * 7
        assert len(gl) == len(el) == 7
        for (_, a), (_, b) in zip(gl, el):
            assert a.dtype == torch.float32 and _same(a, b)

    hcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                               dtype=dtype)
    hp = M.init_params(T.param_defs(hcfg), prng.PRNGKey(0), cuda)
    engine = ServeEngine(hcfg, hp, 64)
    prompts = [tok(40) for _ in range(3)]
    ((tokens, log, counts),) = _served_steps(engine, [prompts], 6, T)
    assert engine._layout["graphs"] is None
    assert [how for how, _ in log] == [None] * 5 and counts == [0] * 5
    pick = lambda lg: torch.argmax(lg[:, -1:, :hcfg.vocab], -1).to(
        torch.int32)
    with torch.inference_mode():
        lg, caches, pos = T.prefill(
            hp, torch.stack([torch.from_numpy(p) for p in prompts]).to(cuda),
            hcfg, 64, last_logits_only=True)
        cur = pick(lg)
        want = [cur]
        for t in range(5):
            lg, caches = T.decode_step(hp, cur, caches, pos + t, hcfg)
            cur = pick(lg)
            want.append(cur)
    assert tokens == torch.cat(want, 1).cpu().tolist()


def _heads_engines(h=60, w=100, duration=0.05):
    from repro_torch.serve import heads

    spec = rs.ReadoutSpec(
        surface=rs.surface(), fast=rs.surface(mode="ideal", tau=5e-3),
        mask=rs.mask(), stcf=rs.stcf(), q=rs.ts_quantized(n_bits=8, tick=1e-4),
        logits=rs.classify(inputs=("surface", "fast"), weights="card-test",
                           n_classes=5, width=16),
        labels=rs.denoise())
    cfg = eng.TSEngineConfig(h=h, w=w, polarities=2, n_slots=4,
                             chunk_capacity=256, specs=(spec,))
    heads.register_head_params("card-test", heads.resolve_head_params(
        rs.classify(inputs=("surface", "fast"), n_classes=5, width=16), cfg,
        "cpu"))
    gpu, cpu = eng.TimeSurfaceEngine(cfg), eng.TimeSurfaceEngine(cfg, "cpu")
    for e in (gpu, cpu):
        for _ in range(cfg.n_slots):
            e.attach()
    words = [aer.pack(datasets.dnd21_like(("driving", "hotel_bar")[k % 2],
                                          h, w, duration, seed=k))
             for k in range(cfg.n_slots)]
    return spec, cfg, gpu, cpu, words


def test_heads_on_card_match_cpu_port(cuda):
    """Heads on the card: logits within rtol 1e-4, atol 1e-4 x max(1,
    max|CPU|) of the CPU port's cnn_apply on the card's own surfaces
    (float32, TF32 off inside the head); labels == stcf >= threshold
    bitwise; the heads launch the three stage-0 kernels; read ==
    read_many with the stage-0 read shared, bitwise."""
    from repro_torch.models import cnn
    from repro_torch.serve import heads

    spec, cfg, gpu, cpu, words = _heads_engines()
    try:
        _lib.reset_launches()
        out = gpu.serve_step(list(enumerate(words)), spec, 0.05)
        assert all(_lib.LAUNCHES[k] > 0 for k in
                   ("ts_decay", "stcf_support", "chunk_scatter"))
        assert torch.isfinite(out["logits"]).all()
        assert torch.equal(out["labels"], out["stcf"] >= cfg.stcf_threshold)
        params = heads.resolve_head_params(spec["logits"], cfg, "cpu")
        from repro_torch.models.frontends import ts_stack_frontend

        want = cnn.cnn_apply(params, ts_stack_frontend(
            [out["surface"].cpu(), out["fast"].cpu()]))
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(out["logits"].cpu(), want, rtol=1e-4,
                                   atol=1e-4 * scale)
        plain = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask())
        both = gpu.read_many([spec, spec.stage0(), plain], 0.05)
        again = gpu.read(spec, 0.05)
        for name in spec.names:
            a, b = both[spec][name], again[name]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), name
        stored = ops.ts_quantize_sae(gpu.state.surfaces.sae, 8, 1e-4)
        q = ref.ts_wrapped_read_ref(stored, 0.05, cfg.tau, 8, 1e-4)
        assert int(ref.ulp_distance(out["q"], q).max()) <= 2
    finally:
        heads.clear_registry()


def test_push_labeled_on_card_matches_cpu(cuda):
    """Supports equal wherever no earlier event of the patch reads within 2
    ULP of V_tw (a superset of the comparator band); the SAE after the
    labeled push bitwise."""
    spec, cfg, gpu, cpu, words = _heads_engines(duration=0.01)
    for k in (0, 1):
        g_sup, g_sig = gpu._sessions[k].push_labeled(words[k])
        c_sup, c_sig = cpu._sessions[k].push_labeled(words[k])
        assert g_sup.device.type == "cuda" and g_sup.shape == c_sup.shape
        s = aer.unpack(words[k], cfg.h, cfg.w)
        x, y, t = (torch.from_numpy(f) for f in (s.x, s.y, s.t))
        dt = t[:, None] - t[None, :]
        near = (((x[:, None] - x[None, :]).abs() <= cfg.stcf_radius)
                & ((y[:, None] - y[None, :]).abs() <= cfg.stcf_radius))
        v = edram.v_mem(dt.clamp_min(0.0), cfg.decay_params())
        band = (near & (dt >= 0) & (ref.ulp_distance(
            v, torch.full_like(v, cfg.v_tw())) <= 2)).any(dim=1)
        assert torch.equal(g_sup.cpu()[~band], c_sup[~band])
        assert torch.equal(g_sig.cpu()[~band], c_sig[~band])
    assert torch.equal(gpu.state.surfaces.sae.cpu().view(torch.int32),
                       cpu.state.surfaces.sae.view(torch.int32))


# ---------------------------------------------------------------------------
# analog fidelity and the stream on the card
# ---------------------------------------------------------------------------

def _analog_spec():
    from repro_torch.serve import fidelity as fm

    a3, a2 = rs.surface(fidelity=fm.analog_3d()), rs.surface(
        fidelity=fm.analog_2d())
    return rs.ReadoutSpec(surface=a3, mask=rs.mask(decay=a3),
                          stcf=rs.stcf(decay=a3), labels=rs.denoise(),
                          s2=a2, st2=rs.stcf(decay=a2))


def _analog_engines(duration=0.03):
    spec = _analog_spec()
    cfg = eng.TSEngineConfig(h=60, w=100, polarities=2, n_slots=4,
                             chunk_capacity=256, specs=(spec,))
    gpu, cpu = eng.TimeSurfaceEngine(cfg), eng.TimeSurfaceEngine(cfg, "cpu")
    items = [(k, aer.pack(datasets.dnd21_like(
        ("driving", "hotel_bar")[k % 2], 60, 100, duration, seed=k)))
        for k in range(cfg.n_slots)]
    for e in (gpu, cpu):
        for _ in range(cfg.n_slots):
            e.attach()
        e.push(items)
    return spec, cfg, gpu, cpu


@pytest.mark.parametrize("step", [0, 7])
def test_analog_read_on_card_matches_cpu_port(cuda, step):
    """The noise drawn on each device (the same threefry bits; CUDA's
    log1p/sqrt in the normal), the reads through the card's ts_decay and
    mask-form stcf_support: surfaces within 8 ULP of the CPU port (the
    analog_2d band), comparator products equal away from V_tw; a repeated
    read bitwise; sigma = 0 bitwise the digital read."""
    from repro_torch.serve import fidelity as fm

    spec, cfg, gpu, cpu = _analog_engines()
    _lib.reset_launches()
    g = gpu.read(spec, 0.03, noise_step=step)
    assert _lib.LAUNCHES["ts_decay"] >= 2 and _lib.LAUNCHES["stcf_support"] >= 2
    c = cpu.read(spec, 0.03, noise_step=step)
    v_tw = torch.full((), cfg.v_tw())
    for surf, st in (("surface", "stcf"), ("s2", "st2")):
        assert int(ref.ulp_distance(g[surf].cpu(), c[surf]).max()) <= 8
        near = ref.ulp_distance(c[surf], v_tw.expand_as(c[surf])) <= 8
        near_p = ref.stcf_support_ref(near, cfg.stcf_radius,
                                      include_self=True) > 0
        assert torch.equal(g[st].cpu()[~near_p], c[st][~near_p])
        if surf == "surface":
            assert torch.equal(g["mask"].cpu()[~near], c["mask"][~near])
            assert torch.equal(g["labels"].cpu()[~near_p],
                               c["labels"][~near_p])
    again = gpu.read(spec, 0.03, noise_step=step)
    assert all(torch.equal(again[n], g[n]) for n in g)
    z = rs.surface(fidelity=fm.analog_3d(sigma=0.0))
    anchor = gpu.read(rs.ReadoutSpec(surface=z), 0.03)["surface"]
    digital = gpu.read(rs.SURFACE_SPEC, 0.03)["surface"]
    assert torch.equal(anchor.view(torch.int32), digital.view(torch.int32))


def test_stcf_support_mask_form_on_analog_masks(cuda):
    """The mask form of stcf_support on analog comparator masks (the
    analog Stcf's path) against its plain version, bitwise."""
    from repro_torch.kernels.stcf import stcf_support_cuda
    from repro_torch.serve import fidelity as fm

    spec, cfg, gpu, _ = _analog_engines()
    eps = fm.cell_eps(fm.analog_3d(), 3, gpu.state.generation,
                      gpu.state.surfaces.sae.shape[1:])
    v = ops.ts_analog_read(gpu.state.surfaces.sae, 0.03, cfg.decay_params(),
                           eps=eps)
    m = v > cfg.v_tw()
    for radius in (1, 3, 7):
        assert torch.equal(stcf_support_cuda(m, radius, False),
                           ref.stcf_support_ref(m, radius))


def test_ring_push_on_card_bitwise_vs_host_push(cuda):
    """push_staged (pinned ring, side-stream copies) == push of the same
    parts, bitwise, over several rounds that reuse both staging sets."""
    cfg = eng.TSEngineConfig(h=60, w=100, polarities=2, n_slots=4,
                             chunk_capacity=256, specs=(
                                 rs.ReadoutSpec(count=rs.Count(4)),))
    a, b = eng.TimeSurfaceEngine(cfg), eng.TimeSurfaceEngine(cfg)
    for e in (a, b):
        for _ in range(cfg.n_slots):
            e.attach()
    streams = [datasets.dnd21_like(("driving", "hotel_bar")[k % 2], 60, 100,
                                   0.04, seed=k) for k in range(cfg.n_slots)]
    for r in range(5):
        lo, hi = r * 0.008, (r + 1) * 0.008
        wins = [s.window(lo, hi) for s in streams]
        a.push([(k, w) for k, w in enumerate(wins)])
        b.push_staged([(k, tuple(f[i:i + 256] for f in (w.x, w.y, w.t, w.p)))
                       for k, w in enumerate(wins)
                       for i in range(0, w.n, 256)])
    torch.cuda.synchronize()
    for x, y in zip((a.state.surfaces.sae, a.state.surfaces.t_last,
                     a.state.surfaces.n_events, a.state.counts,
                     a.state.cache.dirty),
                    (b.state.surfaces.sae, b.state.surfaces.t_last,
                     b.state.surfaces.n_events, b.state.counts,
                     b.state.cache.dirty)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("device_ring", [True, False])
def test_stream_oracle_gate_on_card(cuda, device_ring):
    """A tiered, churned, overloaded stream with an analog gesture tier
    replays bitwise through the synchronous oracle on the card, ring on
    and off giving the same digests."""
    import dataclasses

    from repro_torch.events import replay as rp
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve.stream import StreamConfig

    head = rs.ReadoutSpec(
        surface=rs.surface(fidelity=fm.analog_3d()),
        stcf=rs.stcf(decay=rs.surface(fidelity=fm.analog_3d())),
        labels=rs.denoise(input="stcf"))
    primary = rs.ReadoutSpec(surface=rs.surface())
    cfg = eng.TSEngineConfig(h=60, w=100, polarities=2, n_slots=6,
                             chunk_capacity=1 << 11, specs=(primary,))

    def feeds():
        fs = rp.mixed_scene_feeds(60, 100, 0.06, 5, seed=7, noise_hz=20.0,
                                  churn=True, tiered=True)
        return [dataclasses.replace(f, qos=dataclasses.replace(f.qos,
                                                               spec=head))
                if f.qos.tier == "gesture" else f for f in fs]

    scfg = StreamConfig(policy="drop_oldest", queue_capacity=1 << 12,
                        deadline_s=0.005, step_chunk_budget=3,
                        device_ring=device_ring)
    report = rp.replay(eng.TimeSurfaceEngine(cfg), feeds(), scfg, primary,
                       arrival_substeps=2)
    n = rp.check_oracle(report, lambda: eng.TimeSurfaceEngine(cfg), primary)
    assert n == report.n_steps > 0
    other = rp.replay(eng.TimeSurfaceEngine(cfg), feeds(),
                      dataclasses.replace(scfg, device_ring=not device_ring),
                      primary, arrival_substeps=2)
    assert other.digests == report.digests


# ---------------------------------------------------------------------------
# elastic pools and live migration on the card
# ---------------------------------------------------------------------------

def _fleet_cfg(n_slots=3, slot_bucket=2):
    spec = rs.ReadoutSpec(surface=rs.surface(), count=rs.count(4))
    return eng.TSEngineConfig(h=60, w=100, polarities=2, n_slots=n_slots,
                              slot_bucket=slot_bucket, chunk_capacity=1024,
                              max_dirty_tiles=1 << 20, specs=(spec,))


def _fleet_words(seed, lo, hi):
    s = datasets.dnd21_like(("driving", "hotel_bar")[seed % 2], 60, 100,
                            0.06, seed=seed)
    return aer.pack(s.window(lo, hi))


def test_grow_shrink_migrate_on_card_match_cpu(cuda):
    """The same pushes, a grow, detaches, a migration and a compacting
    shrink on a card engine and a CPU engine: every leaf the scatter and
    the moves write (SAE, ``t_last``, ``n_events``, generation, dirty
    marks, counts) bitwise equal after each move, the cached tiles (decay
    reads) within the decay band of 2 ULP, the same moves; on the card
    the cached ``serve_step`` equals the dense read bitwise after each
    move."""
    cfg = _fleet_cfg()
    gpu, cpu = eng.TimeSurfaceEngine(cfg), eng.TimeSurfaceEngine(cfg, "cpu")

    def leaves(e):
        st = e.state
        return [*st.surfaces, st.generation, st.cache.dirty, st.counts]

    def check_equal():
        for a, b in zip(leaves(gpu), leaves(cpu)):
            assert a.device.type == "cuda" and a.shape == b.shape
            assert torch.equal(a.cpu(), b)
        tiles = gpu.state.cache.tiles.cpu()
        assert int(ref.ulp_distance(tiles, cpu.state.cache.tiles).max()) <= 2

    def serve(items):
        for e in (gpu, cpu):
            got = e.serve_step(items, rs.SURFACE_SPEC, 0.06)["surface"]
        got = gpu.serve_step([], rs.SURFACE_SPEC, 0.06)["surface"]
        dense = gpu.read(rs.SURFACE_SPEC, 0.06)["surface"]
        assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
        check_equal()

    for e in (gpu, cpu):
        for _ in range(3):
            e.attach()
    serve([(s, _fleet_words(s, 0.0, 0.02)) for s in range(3)])
    assert gpu.grow() == cpu.grow() == 5
    for e in (gpu, cpu):
        e.attach(), e.attach()
    check_equal()
    serve([(s, _fleet_words(10 + s, 0.02, 0.04)) for s in range(5)])
    for e in (gpu, cpu):
        e._sessions[0].detach()
        e._sessions[1].detach()
    assert gpu.migrate(4) == cpu.migrate(4) == 0
    check_equal()
    serve([(0, _fleet_words(20, 0.04, 0.06))])
    assert gpu.shrink(3) == cpu.shrink(3) == [(3, 1)]
    check_equal()
    serve([(1, _fleet_words(21, 0.04, 0.06))])


def test_grow_keeps_pending_products(cuda):
    """A pipelined step's products, still pending when an elastic connect
    grows the pool and a migration writes it in place, keep the bytes they
    had when the step was dispatched; the run replays bitwise through the
    oracle on the card."""
    from repro_torch.events import replay as rp
    from repro_torch.serve.stream import StreamConfig, StreamRuntime

    cfg = _fleet_cfg(n_slots=2, slot_bucket=2)
    rt = StreamRuntime(eng.TimeSurfaceEngine(cfg),
                       StreamConfig(elastic=True, pipeline=True,
                                    deadline_s=0.01), rs.SURFACE_SPEC)
    cams = [rt.connect(), rt.connect()]
    for k, cam in enumerate(cams):
        s = aer.unpack(_fleet_words(k, 0.0, 0.01), 60, 100)
        cam.offer((s.x, s.y, s.t, s.p))
    rt.step(0.01)
    pending = rt._inflight
    snap = [{k: v.clone() for k, v in p.items()}
            for p in pending.products_list]
    late = rt.connect()                          # grows the pool to 4
    assert rt.engine.capacity == 4 and late.slot == 2
    rt.migrate(cams[0])                          # in place, onto slot 3
    s = aer.unpack(_fleet_words(5, 0.01, 0.02), 60, 100)
    cams[1].offer((s.x, s.y, s.t, s.p))
    rt.step(0.02)                                # syncs the pending step
    assert pending.record.digest
    for got, want in zip(pending.products_list, snap):
        for k in want:
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32)), k
    rt.flush()
    assert rp.oracle_digests(eng.TimeSurfaceEngine(cfg), rt.log) == [
        e.digest for k, e in rt.log if k == "step"]


# ---------------------------------------------------------------------------
# the slot pool over several shards on the card
# ---------------------------------------------------------------------------

def _shard_engines(cuda, n_shards, n_slots=5):
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _fleet_cfg(n_slots=n_slots, slot_bucket=n_slots)
    mesh = make_host_mesh(n_shards, devices=[cuda])
    return (eng.TimeSurfaceEngine(cfg, mesh=mesh),
            eng.TimeSurfaceEngine(cfg, cuda))


def _same_pool(sharded, plain):
    n = plain.n_slots_padded
    for a, b in zip(eng._leaves(sharded.gather_state()),
                    eng._leaves(plain.state)):
        if b is not None:
            assert a.device == b.device
            assert torch.equal(bits(a[:n]), bits(b))


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_two_shards_on_one_card_match_unsharded(cuda):
    """Two shards on one card, each with tensors of its own: host and ring
    pushes, the FRAME read, the cached ``serve_step`` and the stream's
    digests bitwise the unsharded engine's on the card, the dead tail of
    the padded pool never-written."""
    from repro_torch.events import replay as rp
    from repro_torch.serve.stream import StreamConfig

    sharded, plain = _shard_engines(cuda, 2)
    assert sharded.n_slots_padded == 6 and plain.n_slots_padded == 5
    st0, st1 = sharded._states
    assert st0.surfaces.sae.device == st1.surfaces.sae.device
    assert st0.surfaces.sae.data_ptr() != st1.surfaces.sae.data_ptr()
    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    for e in (sharded, plain):
        for _ in range(5):
            e.attach()
    items = [(s, _fleet_words(s, 0.0, 0.03)) for s in range(5)]
    _lib.reset_launches()
    for e in (sharded, plain):
        e.push(items)
        s = aer.unpack(_fleet_words(7, 0.03, 0.06), 60, 100)
        e.push_staged([(4, (s.x[:1024], s.y[:1024], s.t[:1024],
                            s.p[:1024]))])
    _same_pool(sharded, plain)
    for t_now in (0.06, 0.06):
        got = sharded.serve_step([(1, items[1][1])], frame, t_now)
        want = plain.serve_step([(1, items[1][1])], frame, t_now)
        for k in want:
            assert torch.equal(bits(got[k][:5]), bits(want[k])), k
            assert not bits(got[k][5:]).any(), k
    assert all(_lib.LAUNCHES[k] > 0 for k in
               ("ts_decay", "stcf_support", "chunk_scatter")), _lib.LAUNCHES
    _same_pool(sharded, plain)
    cfg = _fleet_cfg(n_slots=4, slot_bucket=4)
    mesh = sharded.mesh
    feeds = lambda: rp.mixed_scene_feeds(60, 100, 0.04, 4, seed=3,  # noqa
                                         churn=True)
    scfg = StreamConfig(policy="drop_oldest", deadline_s=0.01)
    a = rp.replay(eng.TimeSurfaceEngine(cfg, mesh=mesh), feeds(), scfg)
    b = rp.replay(eng.TimeSurfaceEngine(cfg, cuda), feeds(), scfg)
    assert a.digests == b.digests
    assert rp.check_oracle(
        a, lambda: eng.TimeSurfaceEngine(cfg, mesh=mesh)) == a.n_steps


def test_cross_shard_migration_on_card(cuda):
    """A migration between shards on the card (a row copy into the other
    shard's tensors, then a wipe) leaves the pool bitwise the unsharded
    engine's after the same move, and the cached read equals the dense
    one after it."""
    sharded, plain = _shard_engines(cuda, 4, n_slots=8)
    for e in (sharded, plain):
        for _ in range(8):
            e.attach()
        e.serve_step([(s, _fleet_words(s, 0.0, 0.04)) for s in range(8)],
                     rs.SURFACE_SPEC, 0.04)
        e._sessions[6].detach()
        assert e.migrate(1, 6) == 6       # shard 0 -> shard 3
    _same_pool(sharded, plain)
    got = sharded.serve_step([(6, _fleet_words(9, 0.04, 0.05))],
                             rs.SURFACE_SPEC, 0.05)["surface"]
    want = plain.serve_step([(6, _fleet_words(9, 0.04, 0.05))],
                            rs.SURFACE_SPEC, 0.05)["surface"]
    assert torch.equal(bits(got), bits(want))
    dense = sharded.read(rs.SURFACE_SPEC, 0.05)["surface"]
    assert torch.equal(bits(got), bits(dense))


# ----------------------------------------------------------------------------
# the training path
# ----------------------------------------------------------------------------

def _unet_case(device):
    """The reconstruction protocol's weights and first batch: TS frames
    with large never-written areas, so many activations are exactly 0
    (the ReLU's kink)."""
    from repro_torch.train import recon

    pairs = recon.make_pairs(device="cpu")
    params, _, _ = recon.init(80, 12, device)
    idx = recon.batches(pairs.n_train, 1, 16)[0]
    return params, pairs.x[idx].to(device), pairs.y[idx].to(device)


def test_unet_forward_and_grads_on_card_match_cpu(cuda):
    """cuDNN's TF32 at PyTorch's default (on): ``unet_apply``'s float32
    rule and ``value_and_grad``'s (float32 around the backward too, on
    the direct convolutions the protocol trains on, which keep the exact
    zeros the ReLU's gradient and Adam's step depend on) are what keep
    the card in the CPU band."""
    from repro_torch.models import module as M
    from repro_torch.models.unet import ssim, unet_apply
    from repro_torch.train.grad import value_and_grad

    loss_fn = lambda p, xb, yb: (unet_apply(p, xb) - yb).abs().mean()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        p_card, x_card, y_card = _unet_case(cuda)
        l_card, g_card = value_and_grad(loss_fn, direct=True)(
            p_card, x_card, y_card)
        out_card = unet_apply(p_card, x_card)
        s_card = ssim(out_card, y_card)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled
    p_cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(p_card).items()})
    x_cpu, y_cpu = x_card.cpu(), y_card.cpu()
    l_cpu, g_cpu = value_and_grad(loss_fn)(p_cpu, x_cpu, y_cpu)
    out_cpu = unet_apply(p_cpu, x_cpu)
    scale = max(1.0, float(out_cpu.abs().max()))
    assert torch.allclose(out_card.cpu(), out_cpu, rtol=1e-4,
                          atol=1e-4 * scale)
    assert abs(float(s_card) - float(ssim(out_cpu, y_cpu))) <= 1e-6
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * float(l_cpu)
    for k, w in M.flatten(g_cpu).items():
        got = M.flatten(g_card)[k].cpu()
        assert torch.allclose(got, w, rtol=1e-4,
                              atol=1e-4 * float(w.abs().max())), k
        assert not bool(((w == 0) & (got != 0)).any()), k


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_on_card_matches_cpu(cuda, kind):
    """Every scalar a float32 tensor on the card: no reciprocal path."""
    from repro_torch.models import module as M
    from repro_torch.train import optimizer as O

    g = torch.Generator().manual_seed(4)
    shapes = {"conv.w": (3, 3, 12, 24), "conv.b": (24,), "head.w": (48, 10)}
    params = M.unflatten({k: torch.randn(s, generator=g)
                          for k, s in shapes.items()})
    grads = M.unflatten({k: 0.3 * torch.randn(s, generator=g)
                         for k, s in shapes.items()})
    opt = O.make_optimizer(kind, O.Schedule(3e-3, 5, 80))
    to = lambda t, d: M.unflatten({k: v.to(d)
                                   for k, v in M.flatten(t).items()})
    p_cpu, s_cpu = params, opt.init(params)
    p_card, s_card = to(params, cuda), opt.init(to(params, cuda))
    for i in range(3):
        p_cpu, s_cpu = opt.update(grads, s_cpu, p_cpu, i)
        p_card, s_card = opt.update(to(grads, cuda), s_card, p_card, i)
    for k, w in M.flatten(p_cpu).items():
        got = M.flatten(p_card)[k].cpu()
        assert (got - w).abs().max() <= 1e-3 * 3e-3, k
    for k, w in M.flatten(s_cpu).items():
        got = M.flatten(s_card)[k].cpu().float()
        tol = 2 ** -7 if w.dtype == torch.bfloat16 else 1e-5
        assert (got - w.float()).abs().max() <= tol * float(
            w.float().abs().max()), k


def _scan_grad_inputs(cuda, b, t, c, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.exp(-0.3 * torch.rand((b, t, c), generator=g))
    x, gs = torch.randn((b, t, c), generator=g), torch.randn((b, t, c),
                                                             generator=g)
    s0, gf = torch.randn((b, c), generator=g), torch.randn((b, c), generator=g)
    return [v.to(cuda) for v in (a, x, s0, gs, gf)]


@pytest.mark.parametrize("c", [1001, 1024])       # scalar path, float4 path
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("with_gf", [False, True])
def test_decay_scan_grads_match_autograd_of_plain(cuda, c, with_s0, with_gf):
    """``DecayScan`` on the card: states carry a ``grad_fn``; the backward
    kernel launches once and its gradients are bitwise
    ``decay_scan_bwd_ref``'s and equal in value to autograd of
    ``decay_scan_ref`` (which may give +0 where the kernel gives -0)."""
    a, x, s0, gs, gf = _scan_grad_inputs(cuda, 3, 7, c, 8)
    leaves = [v.clone().requires_grad_(True)
              for v in (a, x) + ((s0,) if with_s0 else ())]
    st, fin = ops.decay_scan(*leaves)
    assert st.grad_fn is not None
    outs, grads = [st], [gs]
    if with_gf:
        outs.append(fin)
        grads.append(gf)
    before = _lib.LAUNCHES["decay_scan_bwd"]
    got = torch.autograd.grad(outs, leaves, grads)
    assert _lib.LAUNCHES["decay_scan_bwd"] == before + 1
    plain = ref.decay_scan_bwd_ref(a, st.detach(), s0 if with_s0 else None,
                                   gs, gf if with_gf else None)
    for u, v in zip(got, [p for p in plain if p is not None]):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    st_r, fin_r = ref.decay_scan_ref(*leaves)
    want = torch.autograd.grad([st_r, fin_r][:len(outs)], leaves, grads)
    for u, v in zip(got, want):
        assert torch.equal(u, v)


def test_decay_scan_grads_central_difference(cuda):
    """The kernel's gradients against float64 central differences of the
    plain forward (the kernel is float32 only): each directional
    derivative within 1e-3 relative."""
    a, x, s0, gs, _ = _scan_grad_inputs(cuda, 2, 6, 64, 9)
    leaves = [v.clone().requires_grad_(True) for v in (a, x, s0)]
    st, _ = ops.decay_scan(*leaves)
    got = torch.autograd.grad(st, leaves, gs)
    g = torch.Generator().manual_seed(10)
    eps = 1e-4
    for i, grad in enumerate(got):
        d = torch.randn(grad.shape, generator=g).to(cuda, torch.float64)

        def f(sign, i=i, d=d):
            args = [v.double() for v in (a, x, s0)]
            args[i] = args[i] + sign * eps * d
            s, total = args[2], 0.0
            for t in range(a.shape[1]):
                s = args[0][:, t] * s + args[1][:, t]
                total = total + (s * gs[:, t].double()).sum()
            return total

        numeric = float(f(1) - f(-1)) / (2 * eps)
        analytic = float((grad.double() * d).sum())
        assert abs(analytic - numeric) <= 1e-3 * abs(numeric), i


def test_reduced_lm_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_step`` of the reduced LM at n_microbatches = 2 on
    the card against the CPU port: loss within 1e-5 relative, gradients
    within rtol 1e-4, atol 1e-4 x max|CPU leaf|, exact zeros kept, and the
    backward kernel launched once a layer a microbatch (the forward twice:
    remat recomputes it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              n_microbatches=2)
    cpu = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), "cpu")
    card = M.unflatten({k: v.to(cuda) for k, v in M.flatten(cpu).items()})
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 40), generator=g)
    labels = torch.randint(0, cfg.vocab, (4, 40), generator=g)
    fn = loop.make_grad_fn(cfg)
    _lib.reset_launches()
    grads, met = fn(card, tokens.to(cuda), labels.to(cuda))
    assert _lib.LAUNCHES["decay_scan"] == 2 * 2 * cfg.n_layers
    assert _lib.LAUNCHES["decay_scan_bwd"] == 2 * cfg.n_layers
    cgrads, cmet = fn(cpu, tokens, labels)
    assert abs(float(met["loss"]) - float(cmet["loss"])) <= 1e-5 * float(
        cmet["loss"])
    for k, w in M.flatten(cgrads).items():
        got = M.flatten(grads)[k].cpu()
        torch.testing.assert_close(got, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))
        assert not bool(((w == 0) & (got != 0)).any()), k


def test_decay_scan_at_hymba_prefill_shape(cuda):
    """``decay_scan`` at the shape hymba-1.5b's prefill gives it (8
    requests, 15 SSD chunks, 25 heads x 64 x state 16 channels) bitwise
    against its plain version, with and without ``s0``."""
    b, t, c = 8, 15, 25 * 64 * 16
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.exp(-torch.rand((b, t, c), generator=g, device=cuda))
    x = torch.randn((b, t, c), generator=g, device=cuda)
    s0 = torch.randn((b, c), generator=g, device=cuda)
    for init in (None, s0):
        before = _lib.LAUNCHES["decay_scan"]
        st, fin = ops.decay_scan(a, x, init)
        assert _lib.LAUNCHES["decay_scan"] == before + 1
        st_r, fin_r = ref.decay_scan_ref(a, x, init)
        assert _same(st, st_r) and _same(fin, fin_r)


@pytest.mark.parametrize("dyadic", [True, False])
def test_route_on_card_matches_cpu(cuda, dyadic):
    """MoE routing on the card against the CPU port (TF32 off): the expert
    choices equal; on logits exact in float32 (dyadic inputs) ``top_w``
    and the aux losses within 8 ULP (CUDA's ``expf`` within 2 ULP of the
    CPU's, and the softmax's sum of 64 exponentials and the mean over the
    tokens in another order: 6 measured on an H100), on float inputs
    within 2e-6 relative (the logits' last bits)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    if dyadic:
        x = torch.randint(-16, 17, (4096, 256), generator=g) / 8
        w = torch.randint(-8, 9, (256, 64), generator=g) / 64
    else:
        x = torch.randn((4096, 256), generator=g)
        w = torch.randn((256, 64), generator=g) / 16
    cfg = get_config("kimi-k2-1t-a32b").reduced(n_experts=64, top_k=8)
    idx, tw, aux = moe.route(w.to(cuda), x.to(cuda), cfg)
    cidx, ctw, caux = moe.route(w, x, cfg)
    assert torch.equal(idx.cpu(), cidx)
    if dyadic:
        assert int(ref.ulp_distance(tw.cpu(), ctw).max()) <= 8
        for k in aux:
            assert int(ref.ulp_distance(aux[k].cpu(), caux[k]).max()) <= 8, k
    else:
        torch.testing.assert_close(tw.cpu(), ctw, rtol=2e-6, atol=0)
        for k in aux:
            torch.testing.assert_close(aux[k].cpu(), caux[k], rtol=2e-6,
                                       atol=0)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "kimi-k2-1t-a32b"])
def test_reduced_hybrid_and_moe_lm_on_card_matches_cpu_port(cuda, arch):
    """The hybrid and MoE families at ``reduced()`` on the card against
    the CPU port: ``forward``'s logits and aux losses, a prefill past the
    window of 32 and 6 decode steps, in the band of
    ``test_reduced_lm_on_card_matches_cpu_port``, positions bitwise;
    hymba's prefill launches ``decay_scan`` once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), "cpu")
    attn = cpu["layers"]["attn"]   # true fan-in, as the dense test scales it
    for w, ref_fan, fan in (("wq", cfg.n_heads, cfg.d_model),
                            ("wk", cfg.n_kv_heads, cfg.d_model),
                            ("wv", cfg.n_kv_heads, cfg.d_model),
                            ("wo", cfg.head_dim, cfg.n_heads * cfg.head_dim)):
        attn[w].mul_((ref_fan / fan) ** 0.5)
    card = M.unflatten({k: v.to(cuda) for k, v in M.flatten(cpu).items()})
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (3, 46), generator=g)

    def close(a, b):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * scale)

    with torch.inference_mode():
        lg, aux = T.forward(card, tokens.to(cuda), cfg)
        lc, caux = T.forward(cpu, tokens, cfg)
        close(lg, lc)
        for k in aux:
            close(aux[k], caux[k])
        _lib.reset_launches()
        lg, cg, _ = T.prefill(card, tokens[:, :40].to(cuda), cfg, 48)
        assert _lib.LAUNCHES["decay_scan"] == (
            cfg.n_layers if cfg.family == "hybrid" else 0)
        lc, cc, _ = T.prefill(cpu, tokens[:, :40], cfg, 48)
        close(lg, lc)
        for i in range(40, 46):
            lg, cg = T.decode_step(card, tokens[:, i:i + 1].to(cuda), cg, i,
                                   cfg)
            lc, cc = T.decode_step(cpu, tokens[:, i:i + 1], cc, i, cfg)
            close(lg, lc)
    for a, b in zip(cg, cc):
        for k, v in M.flatten(a).items():
            if k == "pos":
                assert torch.equal(v.cpu(), b["pos"])
            else:
                close(v, M.flatten(b)[k])


def _shim_words(k):
    return aer.pack(datasets.dnd21_like(("driving", "hotel_bar")[k % 2], 60,
                                        100, 0.06, seed=k))


def _shim_calls(e, words):
    """The deprecated shims' walk of ``test_torch_shims.py`` on engine
    ``e``: every output, in order."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        slots = [e.acquire() for _ in range(2)]
        e.ingest(list(zip(slots, words[:2])))
        out = [e.readout(0.08), *e.readout_with_mask(0.08),
               e.support_map(0.08)]
        out += [e.ingest_and_read([(slots[0], words[2])], t)
                for t in (0.08, 0.08, 0.1)]
        out += list(e.ingest([(slots[1], words[1])], with_support=True)[0])
        e.release(slots[1])
        out.append(e.readout(0.1))
    return out


def _session_calls(e, words):
    """The same walk through the session/spec API."""
    cams = [e.attach() for _ in range(2)]
    for cam, w in zip(cams, words[:2]):
        cam.push(w)
    both = e.read(rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask()), 0.08)
    out = [e.read(rs.SURFACE_SPEC, 0.08)["surface"], both["surface"],
           both["mask"], e.read(rs.ReadoutSpec(stcf=rs.stcf()), 0.08)["stcf"]]
    out += [e.serve_step([(cams[0].slot, words[2])], rs.SURFACE_SPEC,
                         t)["surface"] for t in (0.08, 0.08, 0.1)]
    out += list(cams[1].push_labeled(words[1]))
    cams[1].detach()
    out.append(e.read(rs.SURFACE_SPEC, 0.1)["surface"])
    return out


@pytest.mark.parametrize("shards", [0, 2])
def test_shims_on_card_match_session_path_and_cpu(cuda, shards):
    """The deprecated shims on the card: each of the three kernels
    launched under them, every output bitwise the session/spec twin's on
    the card; against the CPU port's shims, the SAE and label support
    bitwise, surfaces within 2 ULP, masks and support maps equal away
    from V_tw."""
    from repro_torch.launch.mesh import make_host_mesh

    cfg = eng.TSEngineConfig(h=60, w=100, n_slots=3, chunk_capacity=512)

    def make(device):
        mesh = make_host_mesh(shards, device=device) if shards else None
        return eng.TimeSurfaceEngine(cfg, device=device, mesh=mesh)

    words = [_shim_words(k) for k in range(3)]
    old, twin, cpu = make(cuda), make(cuda), make("cpu")
    _lib.reset_launches()
    got = _shim_calls(old, words)
    assert all(_lib.LAUNCHES[k] > 0 for k in
               ("ts_decay", "stcf_support", "chunk_scatter")), _lib.LAUNCHES
    want = _session_calls(twin, words)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(bits(a), bits(b)), i
    host = _shim_calls(cpu, words)
    assert torch.equal(bits(old.gather_state().surfaces.sae.cpu()),
                       bits(cpu.gather_state().surfaces.sae))
    v = host[0]
    near = _near(v, cfg.v_tw(), cfg.stcf_radius)
    for i, (a, b) in enumerate(zip(got, host)):
        a = a.cpu()
        if a.dtype == torch.float32:
            assert int(ref.ulp_distance(a, b).max()) <= 2, i
        elif i in (2, 3):                     # the mask, the support map
            assert torch.equal(a[~near], b[~near]), i
        else:                                 # label support and verdicts
            assert torch.equal(a, b), i


@pytest.mark.parametrize("with_mask", [False, True])
def test_ts_fused_ref_on_card_matches_kernels(cuda, with_mask):
    """``ref.ts_fused_ref`` on the card (plain ops) against the
    ``chunk_scatter`` kernel followed by the ``ts_decay`` kernel on one
    QVGA push with out-of-range, -inf-time and duplicate events: SAE,
    surface and mask bitwise."""
    g = torch.Generator().manual_seed(5)
    sae = _sae("cpu", seed=5, shape=(2, 240, 320))
    n = 60000
    x = torch.randint(-4, 324, (n,), generator=g, dtype=torch.int32)
    y = torch.randint(-4, 244, (n,), generator=g, dtype=torch.int32)
    p = torch.randint(-1, 3, (n,), generator=g, dtype=torch.int32)
    hot = torch.rand(n, generator=g) < 0.3
    x[hot], y[hot] = x[hot] % 8, y[hot] % 8
    t = torch.rand(n, generator=g) * T_NOW
    t[torch.rand(n, generator=g) < 0.1] = float("-inf")
    params = edram.decay_params_for_cmem()
    v_tw = edram.v_tw_for_window(0.024, params) if with_mask else None
    args = [f.to(cuda) for f in (x, y, p, t)]
    want = ref.ts_fused_ref(sae.to(cuda), *args, T_NOW, params, v_tw=v_tw)
    _lib.reset_launches()
    new = sae.to(cuda)[None].clone()
    ev = ts.EventBatch(*(f[None] for f in (args[0], args[1], args[3],
                                           args[2])),
                       valid=torch.ones((1, n), dtype=torch.bool,
                                        device=cuda))
    ops.chunk_scatter_(new, torch.zeros(1, dtype=torch.int32, device=cuda),
                       ev)
    got = ((new[0], ops.ts_decay(new[0], T_NOW, params)) if v_tw is None
           else (new[0], *ops.ts_decay_with_mask(new[0], T_NOW, params,
                                                 v_tw)))
    assert _lib.LAUNCHES["chunk_scatter"] == 1
    assert _lib.LAUNCHES["ts_decay"] == 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
