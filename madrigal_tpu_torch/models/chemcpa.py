"""chemCPA transcriptomics encoder, predict path (port of
`madrigal_tpu/models/chemcpa.py`; reference chemCPA/model.py:290-712).

Madrigal reads `predict(..., return_latent_treated=True)`: the 128-d tx
token per (drug, cell line). This port holds what that path runs: the
basal encoder, the covariate embedding and, with `use_drugs`, the drug
embeddings, their encoder and the dosers. The autoencoder's decoder and
the adversaries serve stage-1 adaptation training and are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ChemCPAConfig
from .mlp import ChemCPAMLP


class GeneralizedSigmoid(nn.Module):
    """Dose-response curve (model.py:234-287); nonlin 'sigm' | 'logsigm'."""

    def __init__(self, dim: int, nonlin: str = "sigm"):
        super().__init__()
        if nonlin not in ("sigm", "logsigm"):
            raise ValueError(nonlin)
        self.nonlin = nonlin
        self.beta = nn.Parameter(torch.ones(1, dim))
        self.bias = nn.Parameter(torch.zeros(1, dim))

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        xin = torch.log1p(x) if self.nonlin == "logsigm" else x
        b = self.bias[0][idx]
        w = self.beta[0][idx]
        return torch.sigmoid(xin * w + b) - torch.sigmoid(b)


class ChemCPAEncoder(nn.Module):
    def __init__(self, cfg: ChemCPAConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.encoder = ChemCPAMLP(
            [c.num_genes] + [c.autoencoder_width] * c.autoencoder_depth
            + [c.dim])
        self.cov_embedding = nn.Embedding(c.num_covariates, c.dim)
        if c.use_drugs:
            self.drug_embeddings = nn.Embedding(c.num_drugs,
                                                c.drug_embedding_dim)
            self.drug_embedding_encoder = ChemCPAMLP(
                [c.drug_embedding_dim]
                + [c.embedding_encoder_width] * c.embedding_encoder_depth
                + [c.dim])
            if c.doser_type == "amortized":
                self.dosers = ChemCPAMLP(
                    [c.drug_embedding_dim + 1]
                    + [c.dosers_width] * c.dosers_depth + [1])
            elif c.doser_type in ("sigm", "logsigm"):
                self.dosers = GeneralizedSigmoid(c.num_drugs, c.doser_type)
            elif c.doser_type is not None:
                raise NotImplementedError(c.doser_type)

    def compute_drug_embeddings(self, drugs_idx: torch.Tensor,
                                dosages: torch.Tensor) -> torch.Tensor:
        """Dose-scaled drug embedding (model.py:575-653)."""
        c = self.cfg
        drugs_idx = drugs_idx.long()
        latent_drugs = self.drug_embeddings(drugs_idx)  # [B, emb]
        if c.doser_type == "amortized":
            inp = torch.cat([latent_drugs, dosages[:, None]], dim=1)
            scaled = self.dosers(inp)[:, 0]
        elif c.doser_type in ("sigm", "logsigm"):
            scaled = self.dosers(dosages, idx=drugs_idx)
        else:
            scaled = dosages
        return scaled[:, None] * self.drug_embedding_encoder(latent_drugs)

    def forward(self, genes: torch.Tensor, covariate_idx: torch.Tensor,
                drugs_idx: Optional[torch.Tensor] = None,
                dosages: Optional[torch.Tensor] = None,
                return_basal: bool = False) -> torch.Tensor:
        """latent_treated [B, dim] (model.py:655-712), or latent_basal."""
        latent = self.encoder(genes)
        if return_basal:
            return latent
        if self.cfg.use_drugs:
            latent = latent + self.compute_drug_embeddings(drugs_idx, dosages)
        return latent + self.cov_embedding(covariate_idx.long())
