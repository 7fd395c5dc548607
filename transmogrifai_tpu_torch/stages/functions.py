"""Serializable functions (counterpart of
``transmogrifai_tpu/stages/functions.py``).

A stage that holds a function (an extract, a predicate, a per-value map)
saves it as the reference does: by a name given with
``@register_function(name)``, or by its importable ``module:qualname``.
Lambdas and closures cannot round-trip and are refused at save time.

Feature types cross between the packages by name: a port type saves under
the reference's module path (``transmogrifai_tpu.types.<module>:<Name>``,
written as a string, never imported here), and such a path loads as the
port's type of that name.  So do the value helpers the DSL stores in its
stages (``ops.domains``' ``email_prefix``, ``email_domain``,
``url_protocol``): the port's and the reference's module of that name hold
the same functions.  Any other path into the reference package is refused on
load: the port never imports it.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional

from .. import types as _types
from ..types import FeatureType, feature_type_by_name

FN_REGISTRY: Dict[str, Callable] = {}
_FN_NAMES: Dict[int, str] = {}
_REFERENCE = "transmogrifai_tpu"
_TYPES_PREFIX = _REFERENCE + ".types."
_PORT = __name__.split(".")[0]
#: modules of value helpers that save under the reference's module path
_MIRRORED_MODULES = ("ops.domains",)


def register_function(name: str):
    """Decorator: make a function serializable under a stable name."""

    def deco(fn: Callable) -> Callable:
        FN_REGISTRY[name] = fn  # opcheck: allow(TM306) registration by decorator, at import time
        _FN_NAMES[id(fn)] = name  # opcheck: allow(TM306) registration by decorator, at import time
        return fn

    return deco


def encode_function(fn: Callable) -> Optional[dict]:
    """Serializable descriptor for ``fn``, or None if it cannot round-trip."""
    if isinstance(fn, type) and issubclass(fn, FeatureType):
        module = fn.__module__.rsplit(".", 1)[-1]
        return {"__imported_fn__": f"{_TYPES_PREFIX}{module}:{fn.__qualname__}"}
    name = _FN_NAMES.get(id(fn))
    if name is not None:
        return {"__registered_fn__": name}
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", "")
    if mod and qual and "<" not in qual:
        try:
            obj = importlib.import_module(mod)
            for part in qual.split("."):
                obj = getattr(obj, part)
            if obj is fn:
                for m in _MIRRORED_MODULES:
                    if mod == f"{_PORT}.{m}":
                        mod = f"{_REFERENCE}.{m}"
                return {"__imported_fn__": f"{mod}:{qual}"}
        except Exception:
            pass
    return None


def decode_function(desc: dict) -> Callable:
    if "__registered_fn__" in desc:
        name = desc["__registered_fn__"]
        if name not in FN_REGISTRY:
            raise ValueError(
                f"Function {name!r} is not registered; import the module that calls "
                f"register_function({name!r}) before loading this model")
        return FN_REGISTRY[name]
    mod, _, qual = desc["__imported_fn__"].partition(":")
    if mod.startswith(_TYPES_PREFIX):
        cls = getattr(_types, qual, None)   # the abstract bases too
        if isinstance(cls, type) and issubclass(cls, FeatureType):
            return cls
        return feature_type_by_name(qual)   # raises, naming the type
    for m in _MIRRORED_MODULES:
        if mod == f"{_REFERENCE}.{m}":
            mod = f"{_PORT}.{m}"
    if mod == _REFERENCE or mod.startswith(_REFERENCE + "."):
        raise ValueError(
            f"saved function {desc['__imported_fn__']!r} lives in the JAX "
            "package, which transmogrifai_tpu_torch never imports")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj
