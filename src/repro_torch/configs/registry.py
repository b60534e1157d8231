"""Registry of the 10 assigned architectures (``--arch <id>``), and of the
port's own configurations (``PORT_ONLY``), which the JAX reference has no
counterpart of and ``ARCHS`` does not list."""

from __future__ import annotations

import importlib

ARCHS: tuple[str, ...] = (
    "zamba2-2.7b",
    "granite-20b",
    "qwen2-1.5b",
    "internlm2-1.8b",
    "granite-34b",
    "olmoe-1b-7b",
    "qwen3-moe-235b-a22b",
    "qwen2-vl-2b",
    "whisper-medium",
    "mamba2-780m",
)

#: configurations only the port runs: published models whose mechanisms the
#: reference's configs cannot state (``models.published``)
PORT_ONLY: tuple[str, ...] = ("olmoe-1b-7b-0924",)

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-20b": "granite_20b",
    "qwen2-1.5b": "qwen2_1p5b",
    "internlm2-1.8b": "internlm2_1p8b",
    "granite-34b": "granite_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
    "olmoe-1b-7b-0924": "olmoe_1b_7b_0924",
}


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS + PORT_ONLY}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
