"""Name -> factory registry for models (larvanet_tpu/core/registry.py:19-55).

Models register under the reference's public names, so `--model=...`
resolves as in the JAX package. Only the names this port has so far are
registered: `edsr` and `edsr_loss`.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(factory: Callable):
        _MODELS[name] = factory
        return factory

    return deco


def _ensure_imported() -> None:
    # importing the package runs every model's register_model decorator
    import larvanet_tpu_torch.models  # noqa: F401


def get_model(name: str):
    """A fresh model wrapper for `--model=<name>`."""
    _ensure_imported()
    if name not in _MODELS:
        raise KeyError("unknown model %r; the port has: %s"
                       % (name, ", ".join(sorted(_MODELS))))
    model = _MODELS[name]()
    model.registry_name = name
    return model
