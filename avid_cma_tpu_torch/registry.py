"""Named component registries (counterpart of avid_cma_tpu/registry.py).

The YAML's ``dataset.name`` picks the dataset class through ``DATASETS``,
populated by the ``@DATASETS.register`` decorator when
``avid_cma_tpu_torch.data`` is imported. The port builds its models and
criterion directly (``train/builders.py``), so it keeps no registry for
them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str | None = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._entries:
                raise KeyError(f"{self.kind} '{key}' already registered")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()


DATASETS = Registry("dataset")
