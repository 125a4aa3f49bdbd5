"""Stage-1 per-modality pretraining (port of `madrigal_tpu/train/
modality_pretrain.py`; reference modality_pretraining/: str/
structure_pretraining_muv.py GIN property prediction, kg/kg_pretraining.py
HGT link prediction with one bilinear decoder shared by every edge type,
cv/cv_pretraining.py the MLP autoencoder, tx/sweep.py chemCPA adaptation
with the alternating adversary step of chemCPA/model.py:729-829).

Every trainer builds its model on the CPU with weights from
`torch.Generator().manual_seed(seed)` (the JAX package's initializer
families, `models/encoder.init_weights`; the streams differ from JAX's),
moves it to `device` (None: the card) and steps it with
`torch.optim.Adam` at optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8,
no weight decay). A parameter the loss does not reach gets a zero
gradient, as optax gives it. Each trainer's `encoder_params()` (chemCPA:
`encoder_variables()`) is the state_dict, parameters and BatchNorm
statistics, that `cli/modality_pretrain.py` writes under
`{str,kg,cv,tx}_encoder.` and `train/transfer.py` overlays on a
MadrigalEncoder.

The evaluations run the model in eval mode on its device and compute
their scores with numpy on the host, as the JAX functions do.
"""
from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ChemCPAConfig, GINConfig, HGTConfig
from ..data.kg import EdgeType, HeteroKGBatch
from ..data.molgraph import MolGraphBatch
from ..device import resolve_device
from ..models.chemcpa import ChemCPAEncoder, gaussian_nll_loss
from ..models.decoder import BilinearDDIScorer
from ..models.encoder import init_weights
from ..models.gin import GINEncoder
from ..models.hgt import HGTEncoder
from ..models.mlp import MLPEncoder


class _AdamTrainer:
    """`model` initialized from `seed`, on `device`, in train mode, with
    one Adam over every parameter."""

    def __init__(self, model: nn.Module, lr: float, seed: int, device):
        self.device = resolve_device(device)
        self.model = init_weights(model, torch.Generator().manual_seed(seed)
                                  ).to(self.device).train()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          eps=1e-8)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _apply(self, optimizer: torch.optim.Optimizer,
               loss: torch.Tensor) -> float:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        optimizer.step()
        return loss.item()


# ---------------------------------------------------------------------------
# Structure: GIN multi-task property prediction (MUV-style)
# ---------------------------------------------------------------------------

class GINPropertyModel(nn.Module):
    """GIN encoder + linear multi-task head (torchdrug PropertyPrediction:
    mean-readout graph feature -> one logit a task)."""

    def __init__(self, gin: GINConfig, feature_dim: int, num_tasks: int):
        super().__init__()
        self.encoder = GINEncoder(
            hidden_dims=tuple(gin.hidden_dims) + (feature_dim,),
            num_mlp_layer=gin.num_mlp_layer, eps_init=gin.eps,
            learn_eps=gin.learn_eps, batch_norm=gin.batch_norm,
            actn=gin.actn, readout=gin.readout, input_dim=gin.atom_dim,
            edge_input_dim=gin.edge_input_dim)
        self.head = nn.Linear(feature_dim, num_tasks)

    def forward(self, batch: MolGraphBatch) -> torch.Tensor:
        return self.head(self.encoder(batch)[0])


class GINPretrainer(_AdamTrainer):
    """Masked multi-task BCE (MUV's labels are sparse):
    sum(per * w) / max(sum(w), 1). BatchNorm statistics update each step."""

    def __init__(self, gin_cfg: GINConfig, feature_dim: int, num_tasks: int,
                 lr: float = 1e-3, seed: int = 0, device=None):
        super().__init__(GINPropertyModel(gin_cfg, feature_dim, num_tasks),
                         lr, seed, device)

    def train_step(self, batch: MolGraphBatch, labels, label_mask) -> float:
        self.model.train()
        out = self.model(batch)
        per = F.binary_cross_entropy_with_logits(
            out, self._tensor(labels, out.dtype), reduction="none")
        w = self._tensor(label_mask, out.dtype)
        return self._apply(self.optimizer,
                           (per * w).sum() / w.sum().clamp_min(1.0))

    def encoder_params(self) -> Dict[str, torch.Tensor]:
        """The GIN's parameters and BatchNorm statistics."""
        return self.model.encoder.state_dict()


# ---------------------------------------------------------------------------
# KG: HGT link prediction (shared bilinear decoder across edge types)
# ---------------------------------------------------------------------------

class HGTLinkPredModel(nn.Module):
    """Reference HGTLinkPred (kg_pretraining.py:78-100): the HGT with a
    head for every node type, and ONE bilinear scorer shared by every edge
    type."""

    def __init__(self, hgt: HGTConfig, feature_dim: int,
                 kg_node_dims: Dict[str, int],
                 kg_edge_types: Sequence[EdgeType]):
        super().__init__()
        self.encoder = HGTEncoder(hgt, feature_dim, kg_node_dims,
                                  kg_edge_types, drug_only_head=False)
        self.decoder = BilinearDDIScorer(1, feature_dim, feature_dim)

    def forward(self, kg: HeteroKGBatch, edge_queries) -> torch.Tensor:
        """edge_queries: list of (src_type, dst_type, src_idx, dst_idx)
        index tensors; returns the concatenated logits. The queries are
        scored over one arena of every node type's embeddings, in
        kg.metadata.node_types order, indices rebased by each type's
        offset, through `triples_indexed`'s recomputed chunks: at the
        reference scale (about 5.16M queries over 122.5k nodes) no [T, D]
        gather is kept beside the full-graph HGT."""
        z = self.encoder(kg)
        order = [nt for nt in kg.metadata.node_types if nt in z]
        offsets, total = {}, 0
        for nt in order:
            offsets[nt] = total
            total += z[nt].shape[0]
        z_all = torch.cat([z[nt] for nt in order])
        si = torch.cat([s.long() + offsets[st] for st, _, s, _ in edge_queries])
        di = torch.cat([d.long() + offsets[dt] for _, dt, _, d in edge_queries])
        return self.decoder.triples_indexed(z_all, si, di,
                                            torch.zeros_like(si))


class HGTLinkPredTrainer(_AdamTrainer):
    """Mean sigmoid BCE over the held-out positives and their corrupted
    negatives. Unlike flax, the model needs the KG schema up front
    (`data.kg.kg_schema`)."""

    def __init__(self, hgt_cfg: HGTConfig, feature_dim: int,
                 kg_node_dims: Dict[str, int],
                 kg_edge_types: Sequence[EdgeType], lr: float = 1e-3,
                 seed: int = 0, device=None):
        super().__init__(HGTLinkPredModel(hgt_cfg, feature_dim, kg_node_dims,
                                          kg_edge_types), lr, seed, device)

    @staticmethod
    def make_link_split(kg_edges: Dict, rng: np.random.RandomState,
                        num_nodes: Dict[str, int], neg_ratio: float = 2.0,
                        holdout: float = 0.2):
        """RandomLinkSplit-style supervision (kg_pretraining.py:41-75):
        per edge type, in dict order, hold out a fraction as positives and
        draw `neg_ratio` corrupted-destination negatives, with the JAX
        package's draws from `rng` in its order. Returns (queries: list of
        (src_type, dst_type, src_idx, dst_idx) int64 arrays, labels float32,
        message_edges: {edge type: [2, kept]})."""
        queries, labels, message_edges = [], [], {}
        for et, ei in kg_edges.items():
            src_t, _, dst_t = et
            ei = np.asarray(ei)
            e = ei.shape[1]
            n_hold = max(1, int(e * holdout))
            perm = rng.permutation(e)
            held, kept = perm[:n_hold], perm[n_hold:]
            message_edges[et] = ei[:, kept]
            pos = ei[:, held]
            n_neg = int(n_hold * neg_ratio)
            neg_src = rng.choice(ei[0], n_neg)
            neg_dst = rng.randint(0, num_nodes[dst_t], n_neg)
            queries.append((
                src_t, dst_t,
                np.concatenate([pos[0], neg_src]).astype(np.int64),
                np.concatenate([pos[1], neg_dst]).astype(np.int64)))
            labels.append(np.concatenate([np.ones(n_hold), np.zeros(n_neg)]))
        return queries, np.concatenate(labels).astype(np.float32), \
            message_edges

    def queries_to_device(self, edge_queries):
        """The queries' index arrays as tensors on the trainer's device
        (copy them once, before the steps)."""
        return [(st, dt, self._tensor(si), self._tensor(di))
                for st, dt, si, di in edge_queries]

    def train_step(self, kg: HeteroKGBatch, edge_queries, labels) -> float:
        self.model.train()
        out = self.model(kg, self.queries_to_device(edge_queries))
        loss = F.binary_cross_entropy_with_logits(
            out, self._tensor(labels, out.dtype))
        return self._apply(self.optimizer, loss)

    def encoder_params(self) -> Dict[str, torch.Tensor]:
        """The HGT's parameters, every node type's head included."""
        return self.model.encoder.state_dict()


# ---------------------------------------------------------------------------
# cv (tabular): MLP autoencoder with MSE (cv_pretraining.py:10-104)
# ---------------------------------------------------------------------------

class TabularAE(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Tuple[int, ...] = (512, 256),
                 latent_dim: int = 128, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.encoder = MLPEncoder(input_dim, tuple(hidden_dims), latent_dim,
                                  dropout=dropout, norm=None, actn="relu")
        self.decoder = MLPEncoder(latent_dim, tuple(reversed(hidden_dims)),
                                  input_dim, dropout=dropout, norm=None,
                                  actn="relu")

    def forward(self, x: torch.Tensor):
        h = F.relu(self.encoder(x))
        return h, self.decoder(F.relu(h))


class TabularAETrainer(_AdamTrainer):
    def __init__(self, input_dim: int, hidden_dims=(512, 256),
                 latent_dim: int = 128, lr: float = 1e-3, seed: int = 0,
                 device=None, dropout: float = 0.2):
        super().__init__(TabularAE(input_dim, tuple(hidden_dims), latent_dim,
                                   dropout), lr, seed, device)

    def train_step(self, x) -> float:
        self.model.train()
        x = self._tensor(x, torch.float32)
        _, recon = self.model(x)
        return self._apply(self.optimizer, torch.mean((recon - x) ** 2))

    def encoder_params(self) -> Dict[str, torch.Tensor]:
        return self.model.encoder.state_dict()


# ---------------------------------------------------------------------------
# tx: chemCPA adaptation (model.py:729-829 update dynamics)
# ---------------------------------------------------------------------------

ADVERSARIES = ("adversary_covariates", "adversary_drugs")


class ChemCPAAdaptTrainer(_AdamTrainer):
    """Alternating autoencoder / adversary optimization: when adversaries
    exist (disable_adv False), every `adversary_steps`-th iteration, the
    first included, updates them (cross-entropy plus a gradient penalty);
    the others update the autoencoder with the Gaussian NLL minus
    `reg_adversary_cov` times the covariate adversary's cross-entropy.
    With disable_adv (the Madrigal adaptation default) only the
    autoencoder step runs.

    As in the JAX trainer, the adversaries and the autoencoder step's
    basal latent use the running BatchNorm statistics as they were before
    the step (eval mode, computed before the train-mode reconstruction
    moves them), and the adversaries' own statistics never move. The
    frozen drug_embeddings table is in no optimizer and takes no gradient
    (chemCPA/embedding.py:10-20)."""

    def __init__(self, cfg: ChemCPAConfig, lr: float = 1e-3,
                 adversary_lr: float = 1e-3, adversary_steps: int = 2,
                 reg_adversary: float = 5.0, reg_adversary_cov: float = 40.0,
                 penalty_adversary: float = 4.0, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.adversary_steps = adversary_steps
        self.reg_adversary = reg_adversary
        self.reg_adversary_cov = reg_adversary_cov
        self.penalty_adversary = penalty_adversary
        super().__init__(ChemCPAEncoder(cfg, adaptation=True), lr, seed,
                         device)
        frozen = ("drug_embeddings",) if (
            cfg.use_drugs and cfg.freeze_drug_embeddings) else ()
        groups = {"ae": [], "adv": []}
        for name, p in self.model.named_parameters():
            top = name.split(".")[0]
            if top in frozen:
                p.requires_grad_(False)
            else:
                groups["adv" if top in ADVERSARIES else "ae"].append(p)
        self.optimizer = torch.optim.Adam(groups["ae"], lr=lr, eps=1e-8)
        self.adv_optimizer = (torch.optim.Adam(groups["adv"], lr=adversary_lr,
                                               eps=1e-8)
                              if groups["adv"] else None)
        self.iteration = 0

    def _ae_step(self, genes, cov, drugs, doses) -> float:
        m = self.model
        if not self.cfg.disable_adv:
            m.eval()  # the statistics before this step's update
            ce = F.cross_entropy(m.adversary_covariates(m.latent_basal(genes)),
                                 cov)
        m.train()
        mean, var = m.reconstruct(genes, cov, drugs, doses)
        loss = gaussian_nll_loss(mean, var, genes)
        if not self.cfg.disable_adv:
            loss = loss - self.reg_adversary_cov * ce
        return self._apply(self.optimizer, loss)

    def _adv_step(self, genes, cov) -> float:
        m = self.model.eval()
        with torch.no_grad():
            basal = m.latent_basal(genes)
        basal.requires_grad_(True)
        logits = m.adversary_covariates(basal)
        ce = F.cross_entropy(logits, cov)
        # gradient penalty on the basal latent (model.py:783-798): a
        # double backward through the adversary
        (grad_b,) = torch.autograd.grad(logits.sum(), basal,
                                        create_graph=True)
        loss = ce + self.penalty_adversary * torch.mean(grad_b ** 2)
        return self._apply(self.adv_optimizer, loss)

    def train_step(self, genes, cov_idx, drugs_idx=None, dosages=None
                   ) -> Dict[str, float]:
        genes = self._tensor(genes, torch.float32)
        cov = self._tensor(cov_idx).long()
        if drugs_idx is not None:
            drugs_idx = self._tensor(drugs_idx).long()
            dosages = self._tensor(dosages, torch.float32)
        run_adv = (not self.cfg.disable_adv
                   and self.iteration % self.adversary_steps == 0)
        if run_adv:
            out = {"loss_adv": self._adv_step(genes, cov)}
        else:
            out = {"loss_reconstruction": self._ae_step(genes, cov, drugs_idx,
                                                        dosages)}
        self.iteration += 1
        return out

    def encoder_variables(self) -> Dict[str, torch.Tensor]:
        """Every parameter and statistic: encoder, decoder, embeddings,
        dosers and adversaries."""
        return self.model.state_dict()

    @torch.no_grad()
    def reconstruct(self, genes, cov_idx, drugs_idx=None, dosages=None):
        """Eval-mode (mean, var) as numpy float32."""
        m = self.model.eval()
        mean, var = m.reconstruct(
            self._tensor(genes, torch.float32), self._tensor(cov_idx).long(),
            None if drugs_idx is None else self._tensor(drugs_idx).long(),
            None if dosages is None else self._tensor(dosages, torch.float32))
        return mean.cpu().numpy(), var.cpu().numpy()

    @torch.no_grad()
    def latent_basal(self, genes) -> np.ndarray:
        return self.model.eval().latent_basal(
            self._tensor(genes, torch.float32)).cpu().numpy()


def evaluate_r2_tx_adapting(trainer: ChemCPAAdaptTrainer, genes, cov_idx,
                            drugs_idx=None, dosages=None) -> float:
    """Uniform-average R2 of the reconstructed means against the true
    signatures (reference: chemCPA/train.py:242-265)."""
    mean, _ = trainer.reconstruct(genes, cov_idx, drugs_idx, dosages)
    y_true = np.asarray(genes)
    y_pred = np.clip(mean, -3e12, 3e12)
    ss_res = ((y_true - y_pred) ** 2).sum(axis=0)
    ss_tot = ((y_true - y_true.mean(axis=0)) ** 2).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = 1.0 - ss_res / ss_tot
    return float(np.nanmean(r2))


def _r2(y_true, y_pred) -> float:
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else float("-inf")


def _condition(n: int, i0: int, drugs_idx, dosages):
    """Drug and dose columns of n rows carrying row i0's condition."""
    if drugs_idx is None:
        return None, None
    return (np.full((n,), int(np.asarray(drugs_idx)[i0]), np.int64),
            np.full((n,), float(np.asarray(dosages)[i0]), np.float32))


def evaluate_r2_per_category(trainer: ChemCPAAdaptTrainer, genes_treated,
                             cov_idx_treated, genes_control, categories,
                             drugs_idx=None, dosages=None,
                             de_gene_idx: Optional[Dict[str, np.ndarray]] = None,
                             min_count: int = 5) -> Dict[str, float]:
    """Per-(covariate, drug, dose)-category R2 of the predicted mean and
    variance profiles, over all genes and the differentially expressed
    ones (reference: chemCPA/train.py:268-460): the CONTROL population
    translated into each category's condition against the category's true
    profiles. Without de_gene_idx the DE scores equal the all-gene ones
    (train.py:112). Returns the means over categories of mean_score,
    mean_score_de, var_score and var_score_de (-inf categories dropped)."""
    genes_treated = np.asarray(genes_treated)
    cov_idx_treated = np.asarray(cov_idx_treated)
    genes_control = np.asarray(genes_control)
    categories = np.asarray(categories)
    n_rows = genes_control.shape[0]
    buckets = {"mean_score": [], "mean_score_de": [],
               "var_score": [], "var_score_de": []}
    for cat, count in zip(*np.unique(categories, return_counts=True)):
        if count <= min_count:
            continue
        low = str(cat).lower()
        if "dmso" in low or "control" in low:
            continue
        idx_all = np.nonzero(categories == cat)[0]
        i0 = idx_all[0]
        mean, var = trainer.reconstruct(
            genes_control, np.full((n_rows,), int(cov_idx_treated[i0])),
            *_condition(n_rows, i0, drugs_idx, dosages))
        y_true = genes_treated[idx_all]
        yt_m, yt_v = y_true.mean(axis=0), y_true.var(axis=0)
        yp_m, yp_v = mean.mean(axis=0), var.mean(axis=0)
        de = (np.asarray(de_gene_idx[cat]) if de_gene_idx and cat in
              de_gene_idx else np.arange(y_true.shape[1]))
        pairs = {"mean_score": (yt_m, yp_m), "var_score": (yt_v, yp_v),
                 "mean_score_de": (yt_m[de], yp_m[de]),
                 "var_score_de": (yt_v[de], yp_v[de])}
        for name, (t, p) in pairs.items():
            r2 = _r2(t, p)
            if np.isfinite(r2):
                buckets[name].append(r2)
    return {k: (float(np.mean(v)) if v else float("nan"))
            for k, v in buckets.items()}


def evaluate_disentanglement(trainer: ChemCPAAdaptTrainer, genes,
                             label_sets: Dict[str, np.ndarray],
                             epochs: int = 400, hidden_layers: int = 2,
                             lr: float = 1e-2, seed: int = 0
                             ) -> Dict[str, float]:
    """Latent-basal disentanglement probe (reference: chemCPA/train.py:
    159-239 and its use at 462-481): the standardized basal latent, then
    an MLP of `hidden_layers` ReLU layers of latent width and a linear
    head (He-normal weights from a torch.Generator seeded with `seed`,
    zero biases), trained full-batch with Adam at `lr` to predict each
    label set. Returns {name: probe accuracy} and {name + '_optimal':
    majority-class frequency}: an accuracy near optimal means the latent
    is disentangled from that factor."""
    basal = trainer.latent_basal(genes)
    mean = basal.mean(axis=0, keepdims=True)
    std = basal.std(axis=0, keepdims=True)  # biased, as torch unbiased=False
    z = trainer._tensor((basal - mean) / np.maximum(std, 1e-8))
    out: Dict[str, float] = {}
    for name, labels in label_sets.items():
        uniq, y = np.unique(np.asarray(labels), return_inverse=True)
        out[name + "_optimal"] = float(np.bincount(y).max() / len(y))
        if len(uniq) < 2:
            out[name] = 1.0
            continue
        gen = torch.Generator().manual_seed(seed)
        sizes = [z.shape[1]] * (hidden_layers + 1) + [len(uniq)]
        layers = [(trainer._tensor(torch.randn(a, b, generator=gen)
                                   * (2.0 / a) ** 0.5).requires_grad_(),
                   trainer._tensor(torch.zeros(b)).requires_grad_())
                  for a, b in zip(sizes[:-1], sizes[1:])]
        opt = torch.optim.Adam([t for wb in layers for t in wb], lr=lr,
                               eps=1e-8)
        yt = trainer._tensor(y).long()

        def forward(x):
            for j, (w, b) in enumerate(layers):
                x = x @ w + b
                if j < len(layers) - 1:
                    x = F.relu(x)
            return x

        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            F.cross_entropy(forward(z), yt).backward()
            opt.step()
        with torch.no_grad():
            pred = forward(z).argmax(dim=1).cpu().numpy()
        out[name] = float((pred == y).mean())
    return out


def evaluate_logfold_r2(trainer: ChemCPAAdaptTrainer, genes_treated,
                        cov_idx_treated, genes_control, cov_idx_control,
                        categories, drugs_idx=None, dosages=None,
                        min_count: int = 5, eps: float = 1e-5):
    """Log2-fold-change R2 and sign accuracy against control (reference:
    chemCPA/train.py:73-157): for each (covariate, drug, dose) category
    with more than min_count treated rows, the treated response predicted
    from that covariate's CONTROL rows carrying the category's drug and
    dose, compared as log2((pred + eps) / (ctrl + eps)) with
    log2((true + eps) / (ctrl + eps)) over the genes where both are
    finite. Returns (mean R2, mean sign accuracy) over categories, or
    (nan, nan) when none qualifies."""
    genes_treated = np.asarray(genes_treated)
    cov_idx_treated = np.asarray(cov_idx_treated)
    genes_control = np.asarray(genes_control)
    cov_idx_control = np.asarray(cov_idx_control)
    categories = np.asarray(categories)
    r2s, signs = [], []
    for cat, count in zip(*np.unique(categories, return_counts=True)):
        if count <= min_count:
            continue
        idx_all = np.nonzero(categories == cat)[0]
        i0 = idx_all[0]
        cov = cov_idx_treated[i0]
        ctrl_rows = np.nonzero(cov_idx_control == cov)[0]
        if len(ctrl_rows) <= 1:
            continue
        g_ctrl = genes_control[ctrl_rows]
        n = len(ctrl_rows)
        mean, _ = trainer.reconstruct(
            g_ctrl, np.full((n,), int(cov)),
            *_condition(n, i0, drugs_idx, dosages))
        y_ctrl = g_ctrl.mean(axis=0)
        y_pred = mean.mean(axis=0)
        y_true = genes_treated[idx_all].mean(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            pred_lfc = np.log2((y_pred + eps) / (y_ctrl + eps))
            true_lfc = np.log2((y_true + eps) / (y_ctrl + eps))
        ok = np.isfinite(pred_lfc) & np.isfinite(true_lfc)
        if ok.sum() < 2:
            continue
        pred_lfc, true_lfc = pred_lfc[ok], true_lfc[ok]
        ss_res = ((true_lfc - pred_lfc) ** 2).sum()
        ss_tot = ((true_lfc - true_lfc.mean()) ** 2).sum()
        if ss_tot > 0:
            r2s.append(float(1.0 - ss_res / ss_tot))
        signs.append(float(((pred_lfc * true_lfc) > 0).mean()))
    if not r2s:
        return float("nan"), float("nan")
    return statistics.mean(r2s), statistics.mean(signs)
