"""The port's quickstart and streaming-denoise examples vs the reference's,
on the CPU.

Each reference example runs through ``runpy.run_path`` with its stdout
captured; its globals hold what it computed.  The port's ``main(["--device",
"cpu"])`` must give the same STCF supports bitwise, the same AUCs within
1e-6, and printed lines with the same words, every integer equal and every
float within one unit of its last printed digit.  The analog surface
sits in ``test_torch_fidelity.py``'s band for ``ISCArray`` reads, 4 ULP
(the per-cell Monte-Carlo draws are normals within 4 ULP of the
reference's); the denoise example's window masks are equal.
"""
import re
import runpy
from pathlib import Path

import jax
import numpy as np
import torch

from repro_torch.kernels import ref as tref

jax.config.update("jax_platforms", "cpu")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ANALOG_ULP = 4
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def run_reference(name: str, capsys) -> tuple:
    """(globals, stdout) of the reference example ``name``."""
    capsys.readouterr()
    g = runpy.run_path(str(EXAMPLES / name))
    return g, capsys.readouterr().out


def port_main(name: str):
    """The ``main`` of the port's example ``name`` (not run)."""
    return runpy.run_path(str(EXAMPLES / name))["main"]


def lines_agree(got: str, want: str, drop=()) -> None:
    """The two outputs print the same lines: the same words, integers
    equal, floats within one unit of the last printed digit.  Spans that
    match a pattern of ``drop`` (host-timed numbers) are cut first, and
    lines that then hold nothing are left out."""
    def lines(text):
        out = []
        for line in text.splitlines():
            for pat in drop:
                line = re.sub(pat, "", line)
            if line.strip():
                out.append(line)
        return out

    g, w = lines(got), lines(want)
    assert len(g) == len(w), (g, w)
    for gl, wl in zip(g, w):
        words = [re.sub(r"\s+", "", _NUM.sub("#", x)) for x in (gl, wl)]
        assert words[0] == words[1], (gl, wl)
        for gn, wn in zip(_NUM.findall(gl), _NUM.findall(wl)):
            if "." not in wn and "e" not in wn:
                assert gn == wn, (gl, wl)
            else:
                unit = 10.0 ** -len(wn.split(".")[1].split("e")[0])
                assert abs(float(gn) - float(wn)) <= unit * (1 + 1e-9), (
                    gl, wl)


def _ulp(a, b) -> int:
    return int(tref.ulp_distance(torch.as_tensor(np.asarray(a, np.float32)),
                                 torch.as_tensor(np.asarray(b, np.float32))
                                 ).max())


def test_quickstart_matches_reference(capsys):
    g, want = run_reference("quickstart.py", capsys)
    got = port_main("quickstart_torch.py")(["--device", "cpu"])
    lines_agree(capsys.readouterr().out, want)
    for name in ("support", "support_i"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(g[name]),
                                      err_msg=name)
    assert abs(got["auc"] - float(g["auc"])) <= 1e-6
    assert abs(got["auc_i"] - float(g["auc_i"])) <= 1e-6
    assert got["surface"].shape == tuple(g["surface"].shape)
    assert _ulp(got["surface"].numpy(), np.asarray(g["surface"])) <= ANALOG_ULP


def test_denoise_stream_matches_reference(capsys):
    g, want = run_reference("denoise_stream.py", capsys)
    got = port_main("denoise_stream_torch.py")(["--device", "cpu"])
    lines_agree(capsys.readouterr().out, want)
    np.testing.assert_array_equal(got["support"].numpy(),
                                  np.asarray(g["sup"]))
    assert abs(got["auc"] - float(g["auc"])) <= 1e-6
    # the reference's globals keep the last mode's masks (2d)
    want_m = np.stack([np.asarray(m) for m in g["masks"]])
    np.testing.assert_array_equal(got["masks"]["2d"].numpy(), want_m)
