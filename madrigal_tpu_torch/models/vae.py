"""Variational autoencoder for tabular modalities (port of
`madrigal_tpu/models/vae.py`; reference models.py:183-208: an MLPEncoder
encoder and decoder with the reparametrization), an alternative stage-1
pretrainer for the tabular views.

Submodule names follow the flax module (`encoder`, `fc_mu`, `fc_var`,
`decoder`). In train mode the reparametrization draws its noise from the
`torch.Generator` the caller passes, on the input's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import MLPEncoder


class VAE(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (512, 256),
                 hidden_dim: int = 128, latent_dim: int = 64,
                 dropout: float = 0.2):
        super().__init__()
        self.encoder = MLPEncoder(input_dim, tuple(hidden_dims), hidden_dim,
                                  dropout=dropout, norm=None, actn="relu")
        self.fc_mu = nn.Linear(hidden_dim, latent_dim)
        self.fc_var = nn.Linear(hidden_dim, latent_dim)
        self.decoder = MLPEncoder(latent_dim, tuple(reversed(hidden_dims)),
                                  input_dim, dropout=dropout, norm=None,
                                  actn="relu")

    def encode(self, x: torch.Tensor):
        h = F.relu(self.encoder(x))
        return self.fc_mu(h), self.fc_var(h)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(z, reconstruction, mu, logvar). Train mode samples z = mu +
        exp(logvar / 2) * noise with noise from `generator` (required);
        eval mode takes z = mu."""
        mu, logvar = self.encode(x)
        if self.training:
            if generator is None:
                raise ValueError("a training VAE needs a torch.Generator "
                                 "for its reparametrization")
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * noise
        else:
            z = mu
        return z, self.decoder(z), mu, logvar


def vae_loss(x: torch.Tensor, recon: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, beta: float = 1.0):
    """(reconstruction MSE + beta * KL, MSE, KL), each a mean."""
    recon_loss = ((recon - x) ** 2).mean()
    kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).mean()
    return recon_loss + beta * kl, recon_loss, kl
