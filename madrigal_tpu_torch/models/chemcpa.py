"""chemCPA transcriptomics encoder (port of `madrigal_tpu/models/
chemcpa.py`; reference chemCPA/model.py:290-712).

Madrigal reads `predict(..., return_latent_treated=True)`: the 128-d tx
token per (drug, cell line). Every ChemCPAEncoder holds what that path
runs: the basal encoder, the covariate embedding and, with `use_drugs`,
the drug embeddings, their encoder and the dosers. With `adaptation`
(stage-1 adaptation training only, `train/modality_pretrain.py`) it also
holds the autoencoder's `decoder` and, unless `disable_adv`, the
adversaries. Flax creates those only when stage 1's `warmup` touches
them, so the encoder that stages 2 and 3 build has no such entries.

The covariate and drug embeddings are looked up with
`ops/gather.gather_rows_grouped`, whose backward is kernel K2 on the
card: `nn.Embedding`'s CUDA backward adds in an order that changes from
run to run. The modules and their weights stay `nn.Embedding`s.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ChemCPAConfig
from ..ops.gather import gather_rows_grouped
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
    def __init__(self, cfg: ChemCPAConfig, adaptation: bool = False):
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
        if adaptation:
            self.decoder = ChemCPAMLP(
                [c.dim] + [c.autoencoder_width] * c.autoencoder_depth
                + [c.num_genes * 2], last_layer_act=c.decoder_activation)
            # the adversaries (model.py:368-376, 442-451)
            if not c.disable_adv:
                adv = [c.dim] + [c.adversary_width] * c.adversary_depth
                self.adversary_covariates = ChemCPAMLP(
                    adv + [c.num_covariates])
                if c.use_drugs:
                    self.adversary_drugs = ChemCPAMLP(adv + [c.num_drugs])

    def compute_drug_embeddings(self, drugs_idx: torch.Tensor,
                                dosages: torch.Tensor) -> torch.Tensor:
        """Dose-scaled drug embedding (model.py:575-653)."""
        c = self.cfg
        drugs_idx = drugs_idx.long()
        latent_drugs = gather_rows_grouped(self.drug_embeddings.weight,
                                           drugs_idx)  # [B, emb]
        if c.doser_type == "amortized":
            inp = torch.cat([latent_drugs, dosages[:, None]], dim=1)
            scaled = self.dosers(inp)[:, 0]
        elif c.doser_type in ("sigm", "logsigm"):
            scaled = self.dosers(dosages, idx=drugs_idx)
        else:
            scaled = dosages
        return scaled[:, None] * self.drug_embedding_encoder(latent_drugs)

    def latent_basal(self, genes: torch.Tensor) -> torch.Tensor:
        return self.encoder(genes)

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
        return latent + gather_rows_grouped(self.cov_embedding.weight,
                                            covariate_idx)

    def reconstruct(self, genes: torch.Tensor, covariate_idx: torch.Tensor,
                    drugs_idx: Optional[torch.Tensor] = None,
                    dosages: Optional[torch.Tensor] = None):
        """(mean, var) of the gene reconstruction, var through softplus
        (model.py:698-704); needs `adaptation`."""
        recon = self.decoder(self(genes, covariate_idx, drugs_idx, dosages))
        dim = recon.shape[-1] // 2
        return recon[..., :dim], F.softplus(recon[..., dim:])


def gaussian_nll_loss(mean: torch.Tensor, var: torch.Tensor,
                      target: torch.Tensor, eps: float = 1e-6
                      ) -> torch.Tensor:
    """torch.nn.GaussianNLLLoss (full=False, reduction='mean') as the JAX
    package writes it: var clamped at eps, the mean over every entry."""
    var = var.clamp_min(eps)
    return 0.5 * torch.mean(torch.log(var) + (target - mean) ** 2 / var)
