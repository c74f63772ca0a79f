"""Name -> factory registries for models and data loaders
(larvanet_tpu/core/registry.py:19-55).

Plugins register under the reference's public names, so `--model=...` and
`--dataloader=...` resolve as in the JAX package. Every name of the JAX
package's registry is registered: the models `edsr`, `edsr_loss`, the
eleven LarvaNet-family presets, the ten of the MSRR family (`msrr`,
`msrr_reduced` and its six ablations, `dwsr_reduced`, `msrr_test`),
`TreeNet`, `REGO-Net`, `REGO-serial`, the EBRN family (`ebrn`, `ebrn_rm`,
`ebrn_rm_BLI`), the HRSR family (`hrsr`, `hrsr_`, `hrsr_c3`), `mamnet` and
`imdn_aim2019`; the six loaders that data/loaders.py registers.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}
_LOADERS: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(factory: Callable):
        _MODELS[name] = factory
        return factory

    return deco


def register_loader(name: str):
    def deco(factory: Callable):
        _LOADERS[name] = factory
        return factory

    return deco


def _ensure_imported() -> None:
    # importing the packages runs every register_* decorator
    import larvanet_tpu_torch.data.loaders  # noqa: F401
    import larvanet_tpu_torch.models  # noqa: F401


def _get(table: Dict[str, Callable], kind: str, name: str):
    _ensure_imported()
    if name not in table:
        raise KeyError("unknown %s %r; the port has: %s"
                       % (kind, name, ", ".join(sorted(table))))
    obj = table[name]()
    obj.registry_name = name
    return obj


def get_model(name: str):
    """A fresh model wrapper for `--model=<name>`."""
    return _get(_MODELS, "model", name)


def get_loader(name: str):
    """A fresh data loader for `--dataloader=<name>`."""
    return _get(_LOADERS, "data loader", name)
