"""Public re-export of the platform registry.

The implementation lives in :mod:`repro_torch.registry` (outside the api package)
so platform modules can register themselves without importing the whole
``repro_torch.api`` surface — see that module's docstring for the import-cycle
rationale.  This shim keeps the documented ``repro_torch.api.registry`` spelling
(and the ``repro_torch.api`` exports) working; both names share one registry.
"""

from repro_torch.registry import (  # noqa: F401
    get_platform,
    list_platforms,
    register_platform,
    try_get_factory,
)

__all__ = [
    "get_platform",
    "list_platforms",
    "register_platform",
    "try_get_factory",
]
