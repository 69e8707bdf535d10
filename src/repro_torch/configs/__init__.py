"""Config registry: ``--arch <id>`` resolution for the port's launchers.

The port serves every LM architecture of the reference's registry, each
config a field-for-field copy of the reference's; ``isc-qvga`` (the
time-surface array's ``ISCConfig``) raises ``NotImplementedError`` until
its slice of the port lands (ROADMAP.md, queue 1).
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
}

#: architectures of the reference's registry not ported yet
NOT_PORTED = ("isc-qvga",)

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib

    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (see "
            f"ROADMAP.md, queue 1); ported: {ARCH_NAMES}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}, "
                       f"not yet ported: {list(NOT_PORTED)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
