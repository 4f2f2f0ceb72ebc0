"""Host-side caching and lazy-import helpers.

Copied from iqwaveform_tpu/utils/caching.py (reference util.py:35-56,
util.py:109-115, and ``optional_import``). Every cached function in the port returns host design
data (windows, bin bounds, index tables), never a device tensor that a
caller could mutate.
"""

from __future__ import annotations

import functools
import importlib.util
import sys

__all__ = ['lazy_import', 'lru_cache', 'optional_import']


def lru_cache(maxsize: int | None = 128, typed: bool = False):
    """functools.lru_cache with the reference's call signature
    (reference util.py:109-115)."""
    return functools.lru_cache(maxsize, typed)


def lazy_import(module_name: str):
    """postponed import of the module with the specified name.

    The import is not performed until the module is accessed in the code
    (reference util.py:35-56).
    """
    cached = sys.modules.get(module_name)
    if cached is not None:
        return cached

    # stock importlib lazy-loading recipe: wrap the spec's loader in a
    # LazyLoader so exec is deferred to first attribute access
    spec = importlib.util.find_spec(module_name)
    if spec is None:
        raise ImportError(f'no module found named "{module_name}"')
    lazy = importlib.util.LazyLoader(spec.loader)
    spec.loader = lazy
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    lazy.exec_module(module)
    return module


def optional_import(module_name: str):
    """return the module if importable, else None (for xarray/pandas gating)."""
    try:
        return importlib.import_module(module_name)
    except ImportError:
        return None
