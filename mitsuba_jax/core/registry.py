"""Plugin registry — by-name instantiation from Properties dicts.

Static replacement for the reference's dlopen plugin machinery
(include/mitsuba/core/plugin.h:92 `PluginManager::createObject`): plugins are
Python factories registered under the same names the XML scene format uses
("path", "lambertian", "sphere", ...). A factory takes a props dict and
returns a scene-object description (typically a pytree dataclass).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable[..., Any]]] = {}


def register_plugin(category: str, name: str):
    """Decorator: register a plugin factory under (category, name)."""

    def deco(fn):
        _REGISTRY.setdefault(category, {})[name] = fn
        return fn

    return deco


def create_plugin(category: str, name: str, props: dict | None = None, **kwargs):
    cat = _REGISTRY.get(category)
    if cat is None or name not in (cat or {}):
        known = sorted((_REGISTRY.get(category) or {}).keys())
        raise KeyError(
            f"No plugin '{name}' in category '{category}'. Known: {known}"
        )
    return cat[name](props or {}, **kwargs)


def plugin_names(category: str):
    return sorted((_REGISTRY.get(category) or {}).keys())


def has_plugin(category: str, name: str) -> bool:
    return name in (_REGISTRY.get(category) or {})
