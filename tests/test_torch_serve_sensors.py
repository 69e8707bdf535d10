"""The port's multi-sensor serving example vs the reference's, on the CPU.

A file of its own: the reference example takes ~25 s here, and
``--dist loadfile`` gives each file one worker.  Its printed lines and the
port's (``main(["--device", "cpu"])``) carry the same words, integer
counters equal and floats within one unit of the last printed digit; the
host-timed numbers (throughput, the p50/p95/p99 latencies) are left out
by name.  The port's own run on 2 CPU shards serves the
same counters and products as its unsharded run.
"""
import runpy
import sys

import torch

from test_torch_examples import EXAMPLES, lines_agree, port_main

HOST_TIMED = (r"throughput \S+ Meps", r"readout latency .*$",
              r"p99 [\d.]+ms")


def test_serve_sensors_matches_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_sensors.py"])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / "serve_sensors.py"), run_name="__main__")
    want = capsys.readouterr().out
    main = port_main("serve_sensors_torch.py")
    one = main(["--device", "cpu"])
    lines_agree(capsys.readouterr().out, want, drop=HOST_TIMED)

    two = main(["--mesh", "2", "--device", "cpu"])
    assert "shard 0 -> cpu, shard 1 -> cpu" in capsys.readouterr().out
    for key in ("occupancy", "active", "n_events", "keep", "counters"):
        assert two[key] == one[key], key
    assert torch.equal(two["logits"], one["logits"])
    for part in ("frame", "model"):
        for name, v in one[part].items():
            got = two[part][name][:v.shape[0]]
            assert torch.equal(got.view(torch.int32) if v.is_floating_point()
                               else got,
                               v.view(torch.int32) if v.is_floating_point()
                               else v), (part, name)
