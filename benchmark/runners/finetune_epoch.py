"""Runner `finetune_epoch`, stage 3: `FinetuneTrainer.train_epoch`, one
full-batch step over the collated training rows (the mix's
`train_share` of the DDI table)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import inputs
from training import PORT, TrainRunner, package


def _half_triples(trainer) -> None:
    """The masked BCE over the first half of the weighted triples only."""
    live = torch.nonzero(trainer.w_all).flatten()
    keep = torch.arange(trainer.w_all.shape[0],
                        device=trainer.w_all.device) < live[len(live) // 2]
    trainer.w_all = trainer.w_all & keep
    trainer.w_directed = trainer.w_directed & keep


class Runner(TrainRunner):
    faults = {"half_batch": _half_triples}

    def build(self, pkg: str, clock):
        m, part = package(pkg), self.parts(clock)
        s32 = inputs.seed32(self.seed)
        layout = {"kg_src_sort": True} if pkg == PORT else {}
        with part("layouts"):
            batch, kg = m.collate.DDICollator(
                self.ds, split="train", seed=s32, device=self.device,
                **layout)(self.rows)
        with part("model"):
            cfg = dataclasses.replace(
                m.C.from_dict(m.C.TrainConfig, self.config["train"]), seed=s32)
            model = m.encoder.build_model(
                m.finetune.training_model_config(cfg), *m.kg.kg_schema(
                    self.ds.kg_node_feats, self.ds.kg_edge_indices),
                device=self.device)
            inputs.load_weights(model, self.seed)
        with part("optimizer"):
            trainer = m.finetune.FinetuneTrainer(cfg, batch, kg, model)
        return trainer, lambda: trainer.train_epoch()["total"]

    @staticmethod
    def reference_forward(trainer):
        """The forwards of one step: the KG table once, then each of the
        mode's forwards (finetune.train_epoch's plan)."""
        mh, mt = (torch.from_numpy(np.ascontiguousarray(m)).to(
            trainer.device) for m in trainer.masker.sample_epoch())
        table = trainer.model.encoder.kg_drug_table(trainer.kg)
        n = (2 + int(trainer.cfg.train_with_str_str)
             if trainer.masker.uses_three_way_loss else 1)
        for _ in range(n):
            trainer._forward_loss(mh, mt, trainer.w_all, table)
