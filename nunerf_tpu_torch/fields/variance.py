"""NeuS single-parameter deviation (inv_s) network; counterpart of
``nunerf_tpu/fields/variance.py`` (reference ``network/field.py:191-208``)."""

from __future__ import annotations

import torch
from torch import nn


class SingleVarianceNetwork(nn.Module):
    def __init__(self, init_val: float = 0.3, activation: str = "exp", device=None):
        super().__init__()
        if activation not in ("exp", "linear", "square"):
            raise NotImplementedError(activation)
        self.init_val = init_val
        self.activation = activation
        self.variance = nn.Parameter(torch.tensor(float(init_val), device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.variance.fill_(self.init_val)

    def forward(self, x):
        if self.activation == "exp":
            val = torch.exp(self.variance * 10.0)
        elif self.activation == "linear":
            val = self.variance * 10.0
        else:
            val = (self.variance * 10.0) ** 2
        return torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device) * val
