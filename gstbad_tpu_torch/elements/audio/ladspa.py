"""LADSPA element family (ext/ladspa/gstladspa{,filter,source,sink}.c)
over the io/ladspa.py host.

Like the reference, elements are REGISTERED DYNAMICALLY from the
plugins found on LADSPA_PATH: one element type per plugin, named
"ladspa-<library>-<label>" (filters), "ladspasrc-..." (no audio
inputs) or "ladspasink-..." (no audio outputs), with properties built
from the control ports (gstladspa.c:158-233).

Since this environment ships no system LADSPA plugins, the default
scan usually registers our native test library
(csrc/ladspa_plugins.c) when its directory is on LADSPA_PATH;
register_ladspa_elements() can be called with an explicit path.

Element API (host-source family):
  - filters: chain(block) with block [n, channels-in] float32 ->
    [n, channels-out]; control-port properties settable between
    blocks (c.f. gstladspafilter.c transform);
  - sources: create(samples) -> [samples, channels] (the reference's
    audiotestsrc-style pull, gstladspasource.c:fill; samplesperbuffer
    default 1024, is-live=False);
  - sinks: chain(block) runs the plugin, output control ports are
    readable as properties (gstladspasink.c render).
A copy of the JAX package's elements/audio/ladspa.py: only its imports differ.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import ladspa as ladspa_io

DEFAULT_RATE = 44100
DEFAULT_SAMPLES_PER_BUFFER = 1024  # gstladspasource.c default


class _LadspaBase(Element):
    PLUGIN: ladspa_io.LadspaPlugin = None
    KIND = "host-source"

    def __init__(self, **props):
        self.rate = int(props.pop("rate", DEFAULT_RATE))
        self._instance = self.PLUGIN.instantiate(self.rate)
        super().__init__(**props)

    # route property access through the live control ports so output
    # controls (sinks' meters) read back current values
    def set_property(self, name: str, value) -> None:
        key = name.replace("_", "-")
        if key in self._propspecs:
            super().set_property(key, value)
            self._instance.set_control(key, self.props[key])
            return
        raise KeyError(f"{self.NAME}: no property {name!r} "
                       f"(has {sorted(self._propspecs)})")

    def get_property(self, name: str):
        key = name.replace("_", "-")
        try:
            return self._instance.get_control(key)
        except ladspa_io.LadspaError:
            return super().get_property(key)

    def close(self) -> None:
        self._instance.close()


class _LadspaFilter(_LadspaBase):
    def chain(self, block) -> np.ndarray:
        block = np.asarray(block, np.float32)
        if block.ndim == 1:
            block = block[:, None]
        return self._instance.run(block.shape[0], block)


class _LadspaSource(_LadspaBase):
    def create(self, samples: int = DEFAULT_SAMPLES_PER_BUFFER
               ) -> np.ndarray:
        return self._instance.run(samples)


class _LadspaSink(_LadspaBase):
    def chain(self, block) -> None:
        block = np.asarray(block, np.float32)
        if block.ndim == 1:
            block = block[:, None]
        self._instance.run(block.shape[0], block)


def _make_element_class(plugin: ladspa_io.LadspaPlugin):
    if not plugin.audio_in:
        base = _LadspaSource
    elif not plugin.audio_out:
        base = _LadspaSink
    else:
        base = _LadspaFilter
    props = []
    for spec in plugin.in_props:
        props.append(Property(spec.name, spec.type, spec.default,
                              spec.minimum, spec.maximum,
                              doc=spec.nick))
    cls = type(f"Ladspa_{plugin.label}", (base,), {
        "NAME": plugin.element_name,
        "PLUGIN": plugin,
        "PROPERTIES": tuple(props),
        "__doc__": f"{plugin.name} by {plugin.maker} "
                   f"(LADSPA #{plugin.unique_id} from "
                   f"{os.path.basename(plugin.filename)})",
    })
    return cls


def register_ladspa_elements(path: Optional[str] = None
                             ) -> List[str]:
    """Scan and register; returns the new element names.  Plugins
    whose element name is already registered are skipped (the
    reference's identifier-collision warning, gstladspa.c:236-241)."""
    from gstbad_tpu_torch.core import registry
    names = []
    for plugin in ladspa_io.scan(path):
        if plugin.element_name in registry.element_names():
            continue
        register(_make_element_class(plugin))
        names.append(plugin.element_name)
    return names


# default scan, like the reference plugin's cached-data path walk
if os.environ.get("LADSPA_PATH"):
    register_ladspa_elements()
