"""repro_torch's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``;
they are marked ``gpu`` and skip inside the ``cuda`` fixture where there
is no card.  Run them on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Bands: decay reads <= 2 ULP from the plain version on the same device (0
expected: both are IEEE float32 with the same ``expf``), comparator masks
and support counts exact away from the threshold (and the fused support
bitwise equal to the mask form's on the kernel's own mask), scatter
results and
``decay_scan`` bitwise (one IEEE product and one IEEE sum per step on both
sides).  The reduced Mamba-2 LM on the card sits within rtol = 1e-4,
atol = 1e-4 x max(1, max|CPU|) of the CPU port in float32: the two
devices sum inside their matrix products in other orders and evaluate
``exp`` with other routines.
"""
import pytest
import torch

from repro_torch.core import edram
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
    assert int(ref.ulp_distance(v, vr).max()) <= 2
    far = ref.ulp_distance(vr, torch.full_like(vr, v_tw)) > 4
    assert torch.equal(m[far], mr[far])
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
    assert int(ref.ulp_distance(v, ref.ts_decay_ref(sae, T_NOW, planes))
               .max()) <= 2


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


def test_reduced_lm_on_card_matches_cpu_port(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-2.7b").reduced()
    cpu = M.init_params(T.param_defs(cfg), torch.Generator().manual_seed(0),
                        "cpu")
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
