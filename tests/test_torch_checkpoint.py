"""The port's ``Checkpointer`` vs the JAX package's, on the CPU.

One directory layout serves both packages: a checkpoint the reference
writes restores in the port and the other way round, every leaf bitwise
(a bfloat16 leaf included, stored as its uint16 bits) and ``extra``
equal.  The port writes its manifest with its own msgpack codec
(``repro_torch.checkpoint.manifest``), byte for byte what
``msgpack.packb`` writes for the same dict.  Atomic writes, retention
and a missing step mirror ``tests/test_checkpoint.py``.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import manifest

jax.config.update("jax_platforms", "cpu")


def _arrays(seed=0):
    """{leaf: numpy array}; the bf16 leaf as float32 values that bf16
    holds exactly."""
    rng = np.random.default_rng(seed)
    bf = np.asarray(jnp.asarray(rng.standard_normal(4), jnp.bfloat16),
                    np.float32)
    return {"conv/w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "conv/b": bf,
            "step_count": rng.integers(0, 99, (2,)).astype(np.int32),
            "mask": rng.random((2, 3)) < 0.5}


def _jax_tree(a):
    return {"conv": {"w": jnp.asarray(a["conv/w"]),
                     "b": jnp.asarray(a["conv/b"], jnp.bfloat16)},
            "step_count": jnp.asarray(a["step_count"]),
            "mask": jnp.asarray(a["mask"])}


def _torch_tree(a):
    return {"conv": {"w": torch.from_numpy(a["conv/w"]),
                     "b": torch.from_numpy(a["conv/b"]).to(torch.bfloat16)},
            "step_count": torch.from_numpy(a["step_count"]),
            "mask": torch.from_numpy(a["mask"])}


def _jax_template(a):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), _jax_tree(a))


def _bits(x):
    x = np.asarray(x.view(torch.int16) if isinstance(x, torch.Tensor)
                   and x.dtype == torch.bfloat16 else x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same(torch_tree, jax_tree):
    got = {"conv/w": torch_tree["conv"]["w"],
           "conv/b": torch_tree["conv"]["b"],
           "step_count": torch_tree["step_count"], "mask": torch_tree["mask"]}
    want = {"conv/w": jax_tree["conv"]["w"], "conv/b": jax_tree["conv"]["b"],
            "step_count": jax_tree["step_count"], "mask": jax_tree["mask"]}
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)
    assert got["conv/b"].dtype == torch.bfloat16


EXTRA = {"cursor": 123, "note": "x", "lr": 0.5, "seen": [1, -2, None, True]}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    a = _arrays(1)
    JCheckpointer(str(tmp_path)).save(7, _jax_tree(a), extra=EXTRA)
    got, extra = Checkpointer(str(tmp_path)).restore(_torch_tree(a),
                                                     device="cpu")
    _assert_same(got, _jax_tree(a))
    assert extra == EXTRA


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    a = _arrays(2)
    Checkpointer(str(tmp_path)).save(7, _torch_tree(a), extra=EXTRA)
    got, extra = JCheckpointer(str(tmp_path)).restore(_jax_template(a))
    _assert_same(_torch_tree(a), got)
    assert extra == EXTRA


def test_manifest_is_msgpack_byte_for_byte(tmp_path):
    a = _arrays(3)
    Checkpointer(str(tmp_path / "t")).save(3, _torch_tree(a), extra=EXTRA)
    JCheckpointer(str(tmp_path / "j")).save(3, _jax_tree(a), extra=EXTRA)
    port, ref = (open(tmp_path / d / "step_00000003" / "manifest.msgpack",
                      "rb").read() for d in ("t", "j"))
    assert port == ref
    assert manifest.unpackb(ref) == msgpack.unpackb(ref)


_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.0, -1.5, 1e300, True, False, None, "", "a" * 31, "a" * 32,
    "a" * 255, "a" * 256, "a" * 65536, "été", b"", b"\x00" * 300,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"nested": {"list": [1, [2, {"x": None}]], "f": 0.25}},
]


@pytest.mark.parametrize("value", _VALUES,
                         ids=[f"v{i}" for i in range(len(_VALUES))])
def test_codec_matches_msgpack(value):
    packed = manifest.packb(value)
    assert packed == msgpack.packb(value)
    assert manifest.unpackb(packed) == msgpack.unpackb(packed)


def test_codec_reads_single_floats_and_refuses_the_rest():
    assert manifest.unpackb(msgpack.packb(0.5, use_single_float=True)) == 0.5
    with pytest.raises(ValueError, match="not a manifest type"):
        manifest.unpackb(msgpack.packb(msgpack.ExtType(1, b"ab")))
    with pytest.raises(ValueError, match="truncated"):
        manifest.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(TypeError, match="cannot pack"):
        manifest.packb({"x": object()})


def test_step_selection_retention_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    trees = {s: _torch_tree(_arrays(s)) for s in (3, 1, 7, 9)}
    for s, tree in trees.items():
        ck.save(s, tree, block=(s != 9))
    ck.wait()
    assert ck.all_steps() == [7, 9] and ck.latest_step() == 9
    for step in (7, None):
        got, _ = ck.restore(trees[3], step=step, device="cpu")
        want = trees[step or 9]
        assert torch.equal(got["conv"]["w"], want["conv"]["w"])
        assert torch.equal(got["step_count"], want["step_count"])


def test_interrupted_write_is_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _torch_tree(_arrays(4))
    ck.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ck.all_steps() == [1]
    got, _ = ck.restore(tree, device="cpu")
    assert torch.equal(got["conv"]["w"], tree["conv"]["w"])


def test_missing_step_and_bad_shapes_raise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _torch_tree(_arrays(5))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ck.restore(tree, device="cpu")
    ck.save(1, tree)
    bad = dict(tree, step_count=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="step_count"):
        ck.restore(bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        ck.restore(tree, step=2, device="cpu")
    os.remove(os.path.join(str(tmp_path), "step_00000001", "conv__w.npy"))
    with pytest.raises(FileNotFoundError):
        ck.restore(tree, device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    tree = _torch_tree(_arrays(6))
    ck.save(1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(tree)
