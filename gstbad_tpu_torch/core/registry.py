"""Element registry — the GST_ELEMENT_REGISTER / factory analog.

The reference registers element factories per plugin bundle
(gst/gaudieffects/gstplugin.c:19-39); here a plain name->class dict serves
`parse_launch` and `make`.
"""

from __future__ import annotations

from typing import Dict, Type

from gstbad_tpu_torch.core.element import Element

_REGISTRY: Dict[str, Type[Element]] = {}


def register(cls: Type[Element]) -> Type[Element]:
    """Class decorator: register an element factory under cls.NAME."""
    if not cls.NAME:
        raise ValueError(f"{cls.__name__} has no NAME")
    if cls.NAME in _REGISTRY and _REGISTRY[cls.NAME] is not cls:
        raise ValueError(f"duplicate element name {cls.NAME!r}")
    _REGISTRY[cls.NAME] = cls
    return cls


def make(name: str, **props) -> Element:
    """gst_element_factory_make analog."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no element {name!r}; known: {sorted(_REGISTRY)}") from None
    return cls(**props)


def element_names():
    return sorted(_REGISTRY)


def get_class(name: str) -> Type[Element]:
    return _REGISTRY[name]
