"""Config: YAML -> attribute-accessible nested dict with dotted
``key.path=value`` overrides and deep merging (counterpart of
avid_cma_tpu/config.py).

The files are read with the port's own YAML reader
(``avid_cma_tpu_torch.yaml_lite``), which gives what ``yaml.safe_load``
gives on the subset of YAML the repo's configs use: the card host has no
PyYAML.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Mapping

from avid_cma_tpu_torch import yaml_lite


class Config(dict):
    """Nested dict with attribute access. Missing keys raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Mapping):
                node[part] = Config()
            node = node[part]
        # a mapping-valued override ('{name: strong}') must become a
        # Config like file-loaded mappings, or attribute access breaks
        node[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def from_dict(d: Mapping) -> Config:
    return _wrap(dict(d))


# YAML 1.1 reads '1e-4' and '1.5e3' as STRINGS (a float needs a dot and a
# signed exponent), so `--set optimizer.lr.base_lr=1e-4` would set a str:
# exponent-form floats are matched first. Everything else keeps YAML
# semantics, so literal strings stay strings.
_SCI_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+")


def _coerce(raw: str) -> Any:
    """Override-value coercion: YAML, plus exponent-form floats."""
    s = raw.strip()
    if _SCI_FLOAT.fullmatch(s):
        return float(s)
    return yaml_lite.safe_load(s)


def load(path: str, overrides: list[str] | None = None) -> Config:
    """Load a YAML config file, optionally applying `key.path=value` overrides."""
    with open(path) as f:
        cfg = from_dict(yaml_lite.safe_load(f) or {})
    for ov in overrides or []:
        key, eq, raw = ov.partition("=")
        if not eq:
            raise ValueError(
                f"override {ov!r} has no '=': expected key.path=value "
                "(a bare key would silently set None)")
        cfg.set_path(key.strip(), _coerce(raw))
    return cfg


def merge(base: Mapping, update: Mapping) -> Config:
    """Deep merge `update` into `base` (returns a new Config)."""
    out = from_dict(base)
    for k, v in update.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(v)
    return out


def dump(cfg: Mapping, path: str) -> None:
    """Write ``cfg`` as YAML that ``yaml.safe_load`` reads back equal."""
    data = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    with open(path, "w") as f:
        yaml_lite.safe_dump(data, f)
