"""LM-decoder training: zero-shot outcome generalization (port of
`madrigal_tpu/train/lm_decoder.py`; reference LM_decoder/
train_ddi_mistral.py, data.py, model.py): the DDI table is split BY
OUTCOME CLASS ('split_by_classes'), so that the evaluation outcomes are
never seen in training, and an LMDecoder head scores (frozen drug
embedding, frozen drug embedding, outcome-text embedding) triples with
BCE, which lets it score outcomes described only by text.

As in the JAX package, the drug-embedding table is computed once and
frozen, and minibatches are fixed-size index arrays into tables on the
trainer's device (drug table [N, D], text table [L, lm_dim] or paraphrase
bank [P, L, lm_dim]), the last batch of an epoch padded from the start of
the epoch's order.

The JAX trainer draws its epoch order, its paraphrase variants and its
dropout masks with `jax.random`, which torch cannot reproduce: this one
draws all three from one `torch.Generator` on its device, seeded with
`seed`, so a run repeats itself but not the JAX run (the tests hold the
draws to their invariants, and the steps to JAX's on the same batches).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.synthetic import EdgeTable
from ..device import resolve_device
from ..models.encoder import init_weights
from ..models.lm_decoder import LMDecoder


def split_by_outcome_classes(
    edge_df: EdgeTable,
    eval_frac: float = 0.2,
    seed: int = 0,
) -> Tuple[EdgeTable, EdgeTable, np.ndarray, np.ndarray]:
    """Partition a long DDI table by OUTCOME class (the reference's
    'split_by_classes' split, LM_decoder/data.py:336): a random
    `eval_frac` of the label ids moves entirely to the eval table, so
    eval outcomes are zero-shot. Returns (train_df, eval_df,
    train_labels, eval_labels)."""
    rng = np.random.RandomState(seed)
    labels = np.unique(edge_df["label_indexed"])
    # eval_frac <= 0 means NO zero-shot holdout (every outcome trains);
    # any positive fraction holds out at least one class
    n_eval = (0 if eval_frac <= 0
              else max(1, int(round(len(labels) * eval_frac))))
    perm = rng.permutation(labels)
    eval_labels = np.sort(perm[:n_eval])
    train_labels = np.sort(perm[n_eval:])
    is_eval = np.isin(edge_df["label_indexed"], eval_labels)
    return (edge_df.take(~is_eval), edge_df.take(is_eval), train_labels,
            eval_labels)


def build_lm_table(
    edge_df: EdgeTable,
    num_drugs: int,
    num_neg_per_pos: int = 1,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Long (head, tail, label, pos_neg) arrays with tail-corruption
    negatives per positive (the reference's LM CSVs carry a precomputed
    pos_neg column; this builds the same layout from a positive-only edge
    table). Negatives keep the outcome so the head learns text-conditional
    discrimination."""
    rng = np.random.RandomState(seed)
    heads = np.asarray(edge_df["head"]).astype(np.int32)
    tails = np.asarray(edge_df["tail"]).astype(np.int32)
    labels = np.asarray(edge_df["label_indexed"]).astype(np.int32)
    pos = {(int(h), int(t), int(l))
           for h, t, l in zip(heads, tails, labels)}

    neg_h, neg_t, neg_l = [], [], []
    for h, t, l in zip(heads, tails, labels):
        for _ in range(num_neg_per_pos):
            for _attempt in range(20):
                cand = int(rng.randint(num_drugs))
                if cand != int(h) and (int(h), cand, int(l)) not in pos:
                    neg_h.append(h)
                    neg_t.append(cand)
                    neg_l.append(l)
                    break
            # else: every draw collided (dense head under this outcome) --
            # emit NOTHING rather than a known positive labeled negative

    out_h = np.concatenate([heads, np.asarray(neg_h, np.int32)])
    out_t = np.concatenate([tails, np.asarray(neg_t, np.int32)])
    out_l = np.concatenate([labels, np.asarray(neg_l, np.int32)])
    pos_neg = np.concatenate([
        np.ones(len(heads), np.float32),
        np.zeros(len(neg_h), np.float32),
    ])
    order = rng.permutation(len(out_h))
    return {"head": out_h[order], "tail": out_t[order],
            "label": out_l[order], "pos_neg": pos_neg[order]}


class LMDecoderTrainer:
    """BCE training of the LMDecoder head over (head, tail, outcome-text)
    triples with a frozen drug-embedding table, on `device` (None: the
    card).

    drug_table: [N, D] frozen Madrigal embeddings (embed_all_drugs output).
    text_table: [L, lm_dim] outcome-description embeddings, or a
        paraphrase bank [P, L, lm_dim] (one variant drawn per row per
        training step; evaluation averages metrics over all variants,
        reference train_ddi_mistral.py:196-240).

    The head's weights come from `torch.Generator().manual_seed(seed)`
    (the JAX package's initializer families, `models/encoder.
    init_weights`), its optimizer is `torch.optim.Adam(lr)` at optax.adam's
    defaults, and its random draws come from `self.generator` (module
    docstring).
    """

    def __init__(
        self,
        drug_table: np.ndarray,
        text_table: np.ndarray,
        project_dim: int = 256,
        mlp_dim: int = 512,
        dropout: float = 0.1,
        self_att: bool = True,
        num_heads: int = 4,
        normalize: bool = False,
        lr: float = 1e-3,
        pos_weight: Optional[float] = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.drug_table = torch.as_tensor(np.asarray(drug_table),
                                          device=self.device)
        text_table = np.asarray(text_table)
        self.paraphrase = text_table.ndim == 3
        self.text_table = torch.as_tensor(text_table, device=self.device)
        self.model = init_weights(LMDecoder(
            lm_emb_dim=text_table.shape[-1], drug_dim=drug_table.shape[1],
            project_dim=project_dim, mlp_dim=mlp_dim, dropout=dropout,
            self_att=self_att, num_heads=num_heads, normalize=normalize,
        ), torch.Generator().manual_seed(seed)).to(self.device)
        self.pos_weight = pos_weight
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          eps=1e-8)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def _index(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).long()

    def _logits(self, head, tail, text) -> torch.Tensor:
        return self.model(self.drug_table[head], self.drug_table[tail], text,
                          generator=self.generator)

    # ------------------------------------------------------------------
    def train_texts(self, label: torch.Tensor) -> torch.Tensor:
        """The text rows of a training batch's outcomes: with a
        paraphrase bank, one variant drawn for each row."""
        if not self.paraphrase:
            return self.text_table[label]
        which = torch.randint(0, self.text_table.shape[0], label.shape,
                              generator=self.generator, device=self.device)
        return self.text_table[which, label]

    def train_step(self, head, tail, label, pos_neg) -> torch.Tensor:
        """One Adam step on a batch (index arrays or tensors, and the 0/1
        targets); returns the loss as a 0-d tensor on the device."""
        head, tail, label = (self._index(x) for x in (head, tail, label))
        y = torch.as_tensor(pos_neg, dtype=torch.float32, device=self.device)
        self.model.train()
        logits = self._logits(head, tail, self.train_texts(label))
        if self.pos_weight is not None:
            # BCEWithLogits + pos_weight ('bce_with_weight')
            loss = F.binary_cross_entropy_with_logits(
                logits, y, pos_weight=torch.tensor(
                    self.pos_weight, dtype=logits.dtype, device=self.device))
        else:
            # reference default 'bce': sigmoid + BCELoss
            loss = F.binary_cross_entropy_with_logits(logits, y)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _validate_table(self, table: Dict[str, np.ndarray]) -> None:
        """Reject out-of-range ids up front: on the card a bad index is a
        device-side assert that ends the process, on the CPU an
        IndexError in the middle of an epoch."""
        n_drugs = int(self.drug_table.shape[0])
        n_out = int(self.text_table.shape[-2])
        for name, limit in (("head", n_drugs), ("tail", n_drugs),
                            ("label", n_out)):
            arr = np.asarray(table[name])
            if len(arr) and (arr.min() < 0 or arr.max() >= limit):
                raise ValueError(
                    f"table['{name}'] ids in [{arr.min()}, {arr.max()}] "
                    f"out of range for a table of {limit} rows -- the "
                    f"{'drug' if name != 'label' else 'text'}-embedding "
                    "table does not cover this dataset"
                )

    def train_epoch(self, table: Dict[str, np.ndarray],
                    batch_size: int = 512) -> float:
        """One pass over the (shuffled) long table; returns mean loss."""
        self._validate_table(table)
        cols = {k: torch.as_tensor(np.asarray(table[k]), device=self.device)
                for k in ("head", "tail", "label", "pos_neg")}
        n = len(cols["head"])
        order = torch.randperm(n, generator=self.generator,
                               device=self.device)
        total = torch.zeros((), device=self.device)
        batches = 0
        for s in range(0, n, batch_size):
            idx = order[s: s + batch_size]
            if len(idx) < batch_size:  # padded from the start of the order
                idx = torch.cat([idx, order[: batch_size - len(idx)]])
            total += self.train_step(*(cols[k][idx] for k in (
                "head", "tail", "label", "pos_neg")))
            batches += 1
        return total.item() / max(batches, 1)

    @torch.no_grad()
    def predict(self, table: Dict[str, np.ndarray],
                variant: Optional[int] = None,
                batch_size: int = 2048) -> np.ndarray:
        """Sigmoid scores; `variant` picks a paraphrase bank row."""
        self._validate_table(table)
        head, tail, label = (self._index(table[k])
                             for k in ("head", "tail", "label"))
        texts = (self.text_table[variant or 0] if self.paraphrase
                 else self.text_table)
        self.model.eval()
        out = []
        for s in range(0, len(head), batch_size):
            sl = slice(s, s + batch_size)
            out.append(torch.sigmoid(self._logits(
                head[sl], tail[sl], texts[label[sl]])).cpu().numpy())
        return np.concatenate(out)

    def evaluate(self, table: Dict[str, np.ndarray], k: int = 50
                 ) -> Dict[str, float]:
        """Binary metrics on (typically zero-shot-outcome) triples; with a
        paraphrase bank, metrics average over every description variant
        (reference evaluate_paraphrased, train_ddi_mistral.py:196-253)."""
        from ..eval.metrics import get_metrics_binary

        ys = np.asarray(table["pos_neg"])
        k = min(k, len(ys))
        if not self.paraphrase:
            return get_metrics_binary(self.predict(table), ys, k)
        per = [
            get_metrics_binary(self.predict(table, variant=i), ys, k)
            for i in range(int(self.text_table.shape[0]))
        ]
        return {
            name: float(np.mean([m[name] for m in per]))
            for name in per[0]
        }
