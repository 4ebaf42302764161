"""PEP 562 lazy exports for the package ``__init__``s (the port's copy of
``ir2rgb_tpu/_lazy.py``).

A thin client (the serving protocol's ``FrameClient``, video IO) imports
``ir2rgb_tpu_torch.infer.server`` or ``ir2rgb_tpu_torch.data.video``
without importing torch: each package declares ``{export_name:
".submodule"}`` and binds the function returned here as its module-level
``__getattr__``.
"""

import importlib


def lazy_exports(pkg_name: str, exports: dict, pkg_globals: dict):
    """A module ``__getattr__`` resolving ``exports`` on first use and
    caching each resolved name into ``pkg_globals``."""

    def __getattr__(name: str):
        mod = exports.get(name)
        if mod is None:
            raise AttributeError(f"module {pkg_name!r} has no attribute "
                                 f"{name!r}")
        val = getattr(importlib.import_module(mod, pkg_name), name)
        pkg_globals[name] = val
        return val

    return __getattr__
