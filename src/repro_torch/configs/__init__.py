"""Config registry: ``--arch <id>`` resolution for the port's launchers.

Every entry of the reference's registry resolves, each config a
field-for-field copy of the reference's: the LM architectures
(``ModelConfig``) and ``isc-qvga``, the paper's time-surface array
(``ISCConfig``), which ``ARCH_NAMES`` leaves out as the reference's does.
"""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec  # noqa: F401

_ARCH_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok_1_314b",
    "musicgen-large": "musicgen_large",
    "gemma2-27b": "gemma2_27b",
    "glm4-9b": "glm4_9b",
    "gemma3-4b": "gemma3_4b",
    "qwen3-8b": "qwen3_8b",
    "mamba2-2.7b": "mamba2_2p7b",
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1p5b",
    "isc-qvga": "isc_qvga",
}

ARCH_NAMES = [n for n in _ARCH_MODULES if n != "isc-qvga"]


def get_config(name: str):
    import importlib

    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
