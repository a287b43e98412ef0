"""Container layers (counterpart: ``paddle_tpu/nn/layer/container.py``
``LayerList``)."""

from __future__ import annotations

from typing import Iterable, Optional

from .layers import Layer

__all__ = ["LayerList"]


class LayerList(Layer):
    """Sublayers named ``"0"``, ``"1"``, ... in order."""

    def __init__(self, sublayers: Optional[Iterable[Layer]] = None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return self._modules[str(idx % len(self))]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())
