"""Runner `cl_step`, stage 2: `CLPretrainer.train_step`, one step over a
drawn batch of the mix's `batch_size` drugs on the device drug table."""
from __future__ import annotations

import dataclasses

import inputs
from training import PORT, TrainRunner, package


def _half_drugs(trainer) -> None:
    """Each step's InfoNCE over the first half of its drawn drugs."""
    draw = trainer._host_batch

    def half():
        ids, m1, m2 = draw()
        h = len(ids) // 2
        return ids[:h], m1[:h], m2[:h]

    trainer._host_batch = half


class Runner(TrainRunner):
    faults = {"half_batch": _half_drugs}

    def build(self, pkg: str, clock):
        m, part = package(pkg), self.parts(clock)
        s32 = inputs.seed32(self.seed)
        layout = {"kg_src_sort": True} if pkg == PORT else {}
        with part("layouts"):
            coll = m.collate.DDICollator(self.ds, split="train", seed=s32,
                                         device=self.device, **layout)
            kg = coll.kg_batch()
        with part("model"):
            cfg = dataclasses.replace(
                m.C.from_dict(m.C.PretrainConfig, self.config["pretrain"]),
                seed=s32, pretrain_batch_size=self.mix["batch_size"])
            model = m.pretrain_cl.build_simclr_model(cfg, *m.kg.kg_schema(
                self.ds.kg_node_feats, self.ds.kg_edge_indices))
            model = model.to(self.device)
            inputs.load_weights(model, self.seed)
        with part("optimizer"):
            trainer = m.pretrain_cl.CLPretrainer(cfg, coll, kg, model,
                                                 device_table=True)
        return trainer, trainer.train_step

    @staticmethod
    def reference_forward(trainer):
        """One step's forward: both views, the KG pass, the predictors and
        the InfoNCE."""
        from reference.data.pipeline import to_device

        ids, m1, m2 = to_device(trainer._host_batch(), trainer.device)
        trainer.model(trainer.full_batch, trainer.kg, m1, m2, ids=ids)
