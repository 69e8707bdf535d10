"""The port's ``launch.serve`` counterparts of the reference's global
flags, on the CPU: ``--platform cpu|gpu`` maps onto the device, ``--platform
tpu``, a platform that contradicts ``--device`` and ``--x64`` are refused
by name."""
import pytest

from repro_torch.launch import serve

SENSORS = ["sensors", "--sensors", "1", "--slots", "2", "--hw", "8x8",
           "--duration", "0.01", "--chunk", "64"]


def _refused(argv, capsys, *words):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    for w in words:
        assert w in err, err


def test_platform_cpu_runs_as_device_cpu(capsys):
    serve.main(["--platform", "cpu", *SENSORS])
    assert "sensor" in capsys.readouterr().out
    serve.main(["--platform", "cpu", *SENSORS, "--device", "cpu"])


def test_platform_gpu_is_the_card_and_contradictions_are_refused(
        capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--platform", "gpu", *SENSORS])
    _refused(["--platform", "gpu", *SENSORS, "--device", "cpu"], capsys,
             "--platform gpu", "--device cpu")
    _refused(["--platform", "cpu", *SENSORS, "--device", "cuda:0"], capsys,
             "--platform cpu", "--device cuda:0")


def test_platform_tpu_is_refused(capsys):
    _refused(["--platform", "tpu", *SENSORS, "--device", "cpu"], capsys,
             "--platform tpu")


def test_x64_is_refused(capsys):
    _refused(["--x64", *SENSORS, "--device", "cpu"], capsys, "--x64",
             "float32")
