"""Platform registry: accelerator platforms keyed by name.

Every accelerator module registers its ``Platform`` subclass at import time,
so campaign specs can refer to platforms declaratively (``platform="vta"``)
instead of importing concrete classes.  ``get_platform`` accepts constructor
kwargs, e.g. ``get_platform("tpu_v5e", knowledge="gray", noise=0.002)``.

This module lives *outside* ``repro_torch.api`` on purpose: platform modules import
it at module scope, and importing anything from the ``repro_torch.api`` package
would run the whole api ``__init__`` (campaign, oracle, cache) — a circular
import the moment a core module like ``repro_torch.core.blocks`` is the first thing
a process imports.  ``repro_torch.api.registry`` re-exports this module's surface,
so the documented public spelling keeps working.  Nothing heavy is imported
here; ``repro_torch.accelerators`` is imported lazily on first lookup so
registration has happened by then.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # annotation-only: keep this module import-light
    from repro_torch.accelerators.base import Platform

_REGISTRY: dict[str, "Callable[..., Platform]"] = {}
_builtins_loaded = False


def register_platform(name: str, factory: "Callable[..., Platform]") -> None:
    """Register a platform factory (usually the class itself) under ``name``."""
    _REGISTRY[name] = factory


def _ensure_builtins() -> None:
    # A flag, not an emptiness check: user code may register custom platforms
    # before the first lookup, which must not mask the built-in four.
    global _builtins_loaded
    if not _builtins_loaded:
        _builtins_loaded = True
        import repro_torch.accelerators  # noqa: F401  (registers the built-in four)


def get_platform(name: str, **kwargs) -> "Platform":
    """Instantiate a registered platform by name."""
    _ensure_builtins()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown platform {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def try_get_factory(name: str) -> "Callable[..., Platform] | None":
    """Registered factory or None — without importing the built-in platforms.

    Runtime pool workers use this after importing their spawn spec's module:
    the spec module has already registered the one platform the worker needs,
    so e.g. a synthetic XLA-CPU worker never pays for the full accelerator
    (and jax) imports.
    """
    return _REGISTRY.get(name)


def list_platforms() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))
