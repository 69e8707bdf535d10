"""The port's model-sharding rules against the reference's, with no
processes: the rules read only ``mesh.shape``, so a stand-in object with
the reference's ``{axis: size}`` dict serves both packages.

For every registered LM config and every mesh of ``MESHES``:
``logical_rules``, each leaf's spec (``partition_specs`` with the expert
weights' specs spliced in, as the reference's ``param_shardings`` splices
them), and ``moe_strategy``'s refusal where the model axis does not fit
the experts; for every mesh, ``batch_spec``, ``input_shardings``,
``cache_seq_axes`` and ``spec_axes``.  Specs are compared per dim as the
tuple of mesh axes (``PartitionSpec`` writes a one-axis tuple as the
axis).
"""
import types

import pytest

from repro.configs import ARCH_NAMES, get_config as jget
from repro.distributed import sharding as jS
from repro.models import module as jM
from repro.models import moe as jMOE
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as tS
from repro_torch.models import module as tM

MESHES = [
    {"data": 1, "model": 1}, {"data": 2, "model": 1},
    {"data": 4, "model": 1}, {"data": 2, "model": 2},
    {"data": 1, "model": 4}, {"data": 2, "model": 4},
    {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _canon(spec):
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _ref_specs(cfg, mesh):
    """The reference's ``param_shardings`` before its ``NamedSharding``
    wrap (which needs devices)."""
    specs = jM.partition_specs(jT.param_defs(cfg), jS.logical_rules(cfg, mesh))
    if cfg.n_experts:
        up, down = jMOE.expert_weight_specs(cfg, mesh.shape["model"],
                                            jS.fsdp_axes(cfg, mesh))
        moe = specs["layers"]["moe"]
        moe["we_gate"] = moe["we_up"] = (None, *up)
        moe["we_down"] = (None, *down)
    return specs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("shape", MESHES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, shape):
    mesh = _mesh(shape)
    jcfg, tcfg = jget(arch), tget(arch)
    try:
        want_rules = jS.logical_rules(jcfg, mesh)
    except ValueError as e:
        with pytest.raises(ValueError, match="not compatible"):
            tS.logical_rules(tcfg, mesh)
        assert "not compatible" in str(e)
        return
    assert tS.logical_rules(tcfg, mesh) == want_rules
    assert tS.fsdp_axes(tcfg, mesh) == jS.fsdp_axes(jcfg, mesh)
    want = _flat(_ref_specs(jcfg, mesh))
    got = _flat(tS.param_shardings(tcfg, mesh))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _canon(got[k]) == _canon(want[k]), (k, got[k], want[k])
    # partition_specs alone, on the rules
    assert _flat(tM.partition_specs({"w": tM.ParamDef((8, 4), (
        "embed", "mlp"))}, want_rules)) == {"w": (want_rules["embed"],
                                                 want_rules["mlp"])}


@pytest.mark.parametrize("shape", MESHES,
                         ids=lambda s: "x".join(map(str, s.values())))
def test_batch_and_cache_specs_match_reference(shape):
    mesh = _mesh(shape)
    tcfg = tget("qwen3-8b")
    for b in (1, 2, 3, 4, 8, 12, 16, 32, 256, 512):
        assert _canon(tS.batch_spec(mesh, b)) == _canon(jS.batch_spec(mesh, b))
        # the reference wraps P(*batch_spec, None) in a NamedSharding
        assert (_canon(tS.input_shardings(tcfg, mesh, b))
                == _canon((*jS.batch_spec(mesh, b), None)))
        assert tS.spec_axes(tS.batch_spec(mesh, b)) == jS.spec_axes(
            jS.batch_spec(mesh, b))
        for s in (1, 15, 16, 64, 4096):
            assert tS.cache_seq_axes(mesh, b, s) == jS.cache_seq_axes(
                mesh, b, s), (b, s)
    for spec in ((None, "model"), (("pod", "data"), None, "model"), ()):
        assert tS.spec_axes(spec) == jS.spec_axes(spec)


def test_placement_of_a_dim_that_does_not_divide_raises():
    """GSPMD would pad such a dim; the port raises for the leaf (the
    rules never split one: a rule whose dim does not divide
    replicates)."""
    mesh = _mesh({"data": 4, "model": 2})
    with pytest.raises(ValueError, match="does not split 4 ways"):
        tS.Placement((6, 8), (("data",), None), mesh)
    pl = tS.Placement((8, 6), (("data",), "model"), mesh)
    assert pl.local_shape == (2, 3)
