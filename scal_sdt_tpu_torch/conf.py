"""Layered YAML configuration for the PyTorch port of SCAL-SDT-TPU.

A copy of the parts of ``scal_sdt_tpu/conf.py`` the port uses so far (it
imports nothing of the JAX package), with the data it ships: the reserved
defaults and the optim-target specs under ``configs/``.

Mirrors the OmegaConf-based config semantics of the original trainer
(MooerFoes/scal-sdt, ``modules/configs.py``): a user YAML is deep-merged over
a reserved defaults file, nested sections are passed around as attribute-style
dicts, and optim-target specs are YAML files referenced by name.

Rather than depend on OmegaConf, this module provides a minimal attribute-dict
(`Config`) with the subset of the OmegaConf API the framework uses: attribute
access, ``.get``, deep merge, YAML load/save.
"""

from __future__ import annotations

import copy
from os import PathLike
from pathlib import Path
from typing import Any, IO, Optional, Union

import yaml

CONFIGS_DIR = Path(__file__).parent / "configs"
OPTIM_TARGETS_DIR = CONFIGS_DIR / "optim_targets"
DEFAULT_PATH = CONFIGS_DIR / "__reserved_default__.yaml"


class Config(dict):
    """Nested dict with attribute access. Lists of dicts become lists of Config."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def __deepcopy__(self, memo) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


ConfigLike = Union[Config, dict, list]


def merge(*configs: ConfigLike) -> Any:
    """Deep merge, rightmost wins. Dicts merge recursively; lists/scalars replace."""
    result: Any = None
    for cfg in configs:
        if cfg is None:
            continue
        cfg = Config._wrap(copy.deepcopy(cfg))
        if isinstance(result, Config) and isinstance(cfg, Config):
            for k, v in cfg.items():
                if k in result and isinstance(result[k], Config) and isinstance(v, Config):
                    result[k] = merge(result[k], v)
                else:
                    result[k] = v
        else:
            result = cfg
    return result


class _Loader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2 float resolver: PyYAML's 1.1 rules parse
    '5e-4' (no dot) as a *string*, which silently breaks lr configs."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    __import__("re").compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""", __import__("re").X),
    list("-+0123456789."),
)


def load(source: Union[str, PathLike, IO]) -> Any:
    if isinstance(source, (str, PathLike)):
        with open(source) as f:
            data = yaml.load(f, _Loader)
    else:
        data = yaml.load(source, _Loader)
    return Config._wrap(data)


def default() -> Config:
    return load(DEFAULT_PATH)


def load_optim_target(target: Union[str, Config]) -> Config:
    """Resolve an optim-target spec: by name from configs/optim_targets, or inline."""
    if isinstance(target, str):
        return load(OPTIM_TARGETS_DIR / f"{target}.yaml")
    if not isinstance(target, Config):
        raise TypeError(f"optim target must be a name or a Config, got {type(target)}")
    return target
