"""Lightweight name->class registries.

The port's own copy of ``espresso_tpu/registry.py``: one generic
``Registry`` class (tasks, models, criterions, ...), the named architecture
presets (``register_architecture`` / ``apply_architecture``) and
``dataclass_from_dict``. Each registered entry may carry a config
dataclass. The port's entries register themselves where they are defined
(``models/transducer.py``, ``tasks.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Type


class Registry:
    """A named registry mapping string keys to (cls, config_cls) pairs."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}
        self._configs: Dict[str, Optional[type]] = {}

    def register(self, key: str, config: Optional[type] = None) -> Callable:
        def wrapper(cls):
            if key in self._entries and self._entries[key] is not cls:
                raise ValueError(
                    f"duplicate registration of {key!r} in registry {self.name!r}"
                )
            self._entries[key] = cls
            self._configs[key] = config
            return cls

        return wrapper

    def get(self, key: str):
        if key not in self._entries:
            raise KeyError(
                f"unknown {self.name} {key!r}; available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def config_class(self, key: str) -> Optional[type]:
        return self._configs.get(key)

    def keys(self):
        return sorted(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def build(self, key: str, *args, **kwargs):
        return self.get(key)(*args, **kwargs)


TASKS = Registry("task")
MODELS = Registry("model")
# named architecture presets: key -> callable(config)->config mutating defaults
ARCHITECTURES: Dict[str, Callable] = {}
CRITERIONS = Registry("criterion")
TOKENIZERS = Registry("tokenizer")


def register_architecture(model_name: str, arch_name: str):
    """Register a named architecture preset (reference: register_model_architecture).

    The decorated function mutates a model config dataclass in place, filling
    architecture-specific defaults (cf. espresso/models/speech_lstm.py:1099-1123).
    """

    def wrapper(fn):
        if arch_name in ARCHITECTURES:
            raise ValueError(f"duplicate architecture {arch_name!r}")
        ARCHITECTURES[arch_name] = (model_name, fn)
        return fn

    return wrapper


def apply_architecture(arch_name: str, model_cfg) -> str:
    """Apply a named arch preset to a model config; returns the base model name."""
    if arch_name in ARCHITECTURES:
        model_name, fn = ARCHITECTURES[arch_name]
        fn(model_cfg)
        return model_name
    return arch_name


def dataclass_from_dict(cls: Type, data: Dict[str, Any]):
    """Recursively build a dataclass from a (possibly nested) dict."""
    if not dataclasses.is_dataclass(cls):
        return data
    field_types = {f.name: f.type for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in field_types:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = field_types[key]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = dataclass_from_dict(ftype, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)
