"""Source-embedding pickles for long-lived artifacts (the port's own copy
of ``latte_tpu/persistence.py``).

``@persistent_class`` embeds the source of the decorated class's module into
the pickles of its instances, so archived objects keep loading after the
code base moves on (or without it: the class is rebuilt from the embedded
source). The port's checkpoints are state dicts (no code); this serves the
evaluation caches and ad-hoc experiment artifacts, as in the reference.
"""

from __future__ import annotations

import copyreg
import inspect
import io
import pickle
import sys
import types
import uuid
from typing import Any, Dict

_version = 1
_decorators = set()
_import_cache: Dict[str, types.ModuleType] = {}


def persistent_class(orig_class: type) -> type:
    """Decorate a class so pickles of its instances embed its source."""
    assert isinstance(orig_class, type)
    if is_persistent(orig_class):
        return orig_class

    src_module = sys.modules[orig_class.__module__]
    # synthetic archive modules carry their source as an attribute
    src_code = getattr(src_module, "__latte_torch_module_src__", None)
    if src_code is None:
        src_code = inspect.getsource(src_module)

    class Decorator(orig_class):
        _orig_class_name = orig_class.__name__

        @property
        def init_args(self):
            return getattr(self, "_init_args", ())

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._init_args = args
            self._init_kwargs = kwargs

        def __reduce__(self):
            state = self.__dict__.copy()
            meta = {
                "type": "class",
                "version": _version,
                "module_src": src_code,
                "class_name": self._orig_class_name,
                "state": state,
            }
            return _reconstruct_persistent_obj, (meta,)

    Decorator.__name__ = orig_class.__name__
    Decorator.__qualname__ = orig_class.__qualname__
    _decorators.add(Decorator)
    return Decorator


def is_persistent(obj: Any) -> bool:
    try:
        if obj in _decorators:
            return True
    except TypeError:
        pass
    return type(obj) in _decorators


def _src_to_module(src: str) -> types.ModuleType:
    key = str(hash(src))
    if key not in _import_cache:
        module_name = "_latte_torch_persistence_" + uuid.uuid4().hex
        module = types.ModuleType(module_name)
        module.__latte_torch_module_src__ = src
        sys.modules[module_name] = module
        exec(src, module.__dict__)  # noqa: S102 - controlled archive payload
        _import_cache[key] = module
    return _import_cache[key]


def _reconstruct_persistent_obj(meta: Dict[str, Any]):
    assert meta["type"] == "class" and meta["version"] == _version
    module = _src_to_module(meta["module_src"])
    orig_class = getattr(module, meta["class_name"])
    decorated = persistent_class(orig_class)
    obj = decorated.__new__(decorated)
    obj.__dict__.update(meta["state"])
    return obj
