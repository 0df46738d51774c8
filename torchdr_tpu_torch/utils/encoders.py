"""Parametric encoders (counterpart of ``torchdr_tpu/utils/encoders.py``).

An estimator given ``encoder=`` optimizes the network's weights instead of
a free embedding matrix, so that ``transform`` embeds rows it has not
seen. Any ``torch.nn.Module`` mapping (n, d_in) rows to (n, n_components)
serves; its parameters as they stand are the fit's starting point.
:class:`MLP` is the JAX package's flax MLP in torch: its ``Linear`` layers
are made when it first sees its input width, as flax's ``Dense`` infers
it, and each fit draws them afresh with flax's default initialization.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# flax's lecun_normal draws a normal truncated to ±2 and divides its scale
# by this, the standard deviation of that truncated normal
_TRUNCATED_NORMAL_STD = 0.87962566103423978


class MLP(torch.nn.Module):
    """ReLU MLP: ``features`` are the hidden widths, then the output width."""

    def __init__(self, features: Sequence[int]):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.layers = torch.nn.ModuleList()

    def build(self, in_features: int) -> "MLP":
        """Make the ``Linear`` layers for ``in_features`` input columns, their
        weights left unset (``init_variables`` or ``load_encoder_variables``
        sets them)."""
        widths = (int(in_features),) + self.features
        if len(self.layers) == 0 or self.layers[0].in_features != widths[0]:
            self.layers = torch.nn.ModuleList(
                torch.nn.utils.skip_init(torch.nn.Linear, a, b)
                for a, b in zip(widths[:-1], widths[1:])
            )
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x

    def init_variables(self, X: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """flax ``Dense``'s default draw on X's device: each weight from a
        normal truncated to ±2 times sqrt(1/fan_in)/0.8796 (lecun_normal),
        each bias zero; the weights in layer order, from ``generator``."""
        self.build(X.shape[1])
        variables = {}
        for i, layer in enumerate(self.layers):
            w = torch.empty((layer.out_features, layer.in_features), dtype=X.dtype, device=X.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            variables[f"layers.{i}.weight"] = w * ((1.0 / layer.in_features) ** 0.5
                                                   / _TRUNCATED_NORMAL_STD)
            variables[f"layers.{i}.bias"] = torch.zeros(
                layer.out_features, dtype=X.dtype, device=X.device
            )
        return variables


def make_mlp_encoder(out_dim: int, hidden: Sequence[int] = (32,)) -> MLP:
    return MLP(features=tuple(hidden) + (out_dim,))


def init_encoder_variables(encoder: torch.nn.Module, X: torch.Tensor,
                           generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The fit's starting weights, by name, on X's device: an :class:`MLP`'s
    fresh draw, or any other module's parameters as they stand."""
    if isinstance(encoder, MLP):
        return encoder.init_variables(X, generator)
    return {name: p.detach().to(device=X.device, dtype=X.dtype).clone()
            for name, p in encoder.named_parameters()}
