"""The single-drug head and the extra tabular encoders of the port
against the JAX package.

  * With NON_TX_MODALITIES=str_kg_cv_bs (in a subprocess, since the
    modality list is fixed at import), a model with the bs encoder and a
    single-drug head carried from the JAX model's init gives the JAX
    scores and score_single_drug (atol = rtol = 1e-5), its config read
    back from a dict.
  * A use_single_drug trainer builds the head and steps without training
    it; a model that disagrees with the config is refused.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.eval.predict import model_from_checkpoint
from madrigal_tpu_torch.models.encoder import build_model, init_weights
from madrigal_tpu_torch.train import finetune as t_ft
from madrigal_tpu_torch.train.checkpoint import save_checkpoint
from test_torch_train import data, one_thread, tiny_cfg  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_drug_trainer(data, tmp_path):  # noqa: F811
    """use_single_drug builds the head; without it the trainer's model
    has none, and a model that disagrees with the config is refused. The
    step does not train the head: AdamW decays it, its gradient 0. A
    checkpoint rebuilds the model its config trains, and one whose
    weights disagree with its config is refused."""
    dt, _, _, bt, kt = data
    cfg = tiny_cfg(t_config, "full_full")
    cfg = dataclasses.replace(cfg, use_single_drug=True, model=(
        dataclasses.replace(cfg.model, prediction_dim_single_drug=3)))
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    model = init_weights(build_model(t_ft.training_model_config(cfg),
                                     *schema, device="cpu"),
                         torch.Generator().manual_seed(0))
    plain = build_model(t_ft.training_model_config(
        dataclasses.replace(cfg, use_single_drug=False)), *schema,
        device="cpu")
    assert not hasattr(plain, "single_drug_head")
    with pytest.raises(ValueError, match="training_model_config"):
        t_ft.FinetuneTrainer(cfg, bt, kt, plain)
    trainer = t_ft.FinetuneTrainer(cfg, bt, kt, model)
    head = model.single_drug_head.weight.detach().clone()
    for _ in range(2):  # the warmup's first learning rate is 0
        assert np.isfinite(trainer.train_epoch()["total"])
    assert not model.single_drug_head.weight.grad.any()
    assert not torch.equal(model.single_drug_head.weight, head)

    path = str(tmp_path / "ckpt.pt")
    for use, m in ((True, model), (False, plain)):
        save_checkpoint(path, m.state_dict(),
                        dataclasses.replace(cfg, use_single_drug=use), epoch=2)
        back, _ = model_from_checkpoint(path, device="cpu")
        assert hasattr(back, "single_drug_head") == use
    save_checkpoint(path, plain.state_dict(), cfg, epoch=2)
    with pytest.raises(RuntimeError, match="single_drug_head"):
        model_from_checkpoint(path, device="cpu")


# --------------------------------------------------- extra tabular (bs)
SCRIPT = textwrap.dedent("""
    import os
    os.environ["NON_TX_MODALITIES"] = "str_kg_cv_bs"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import numpy as np
    import torch

    from madrigal_tpu import config as jc
    from madrigal_tpu.data import collate as j_collate
    from madrigal_tpu.data import synthetic as j_syn
    from madrigal_tpu.models.encoder import MadrigalMultilabel, init_multilabel
    from madrigal_tpu_torch import config as tc
    from madrigal_tpu_torch.constants import NUM_MODALITIES
    from madrigal_tpu_torch.data import collate as t_collate
    from madrigal_tpu_torch.data import synthetic as t_syn
    from madrigal_tpu_torch.data.kg import kg_schema
    from madrigal_tpu_torch.interop.from_flax import load_flax_weights
    from madrigal_tpu_torch.models.encoder import MadrigalMultilabel as TM

    assert NUM_MODALITIES == 20

    def enc(c):
        return c.EncoderConfig(
            feature_dim=16,
            gin=c.GINConfig(hidden_dims=(16,), num_mlp_layer=2),
            hgt=c.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
            cv=c.MLPEncoderConfig(hidden_dims=(32, 16), norm="bn"),
            extra_tabular={"bs": c.MLPEncoderConfig(
                input_dim=48, hidden_dims=(32, 16), norm="ln")},
            chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                    autoencoder_depth=1),
            transformer=c.FusionConfig(num_layers=1, att_heads=2,
                                       head_dim=8, ffn_dim=32, dropout=0.0,
                                       norm_first=True, agg="x-attn",
                                       num_tx_bottlenecks=2),
            proj=c.ProjectorConfig(hidden_dims=(32, 32)),
            pos_emb_type="sinusoidal")

    kw = dict(num_drugs=10, num_labels=3, num_edges=12, seed=33,
              extra_tabular_dims={"bs": 48})
    dj, dt = j_syn.make_dataset(**kw), t_syn.make_dataset(**kw)
    np.testing.assert_array_equal(dt.extra_tabular["bs"],
                                  dj.extra_tabular["bs"])
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0)()
    bt, kt = t_collate.DDICollator(dt, split="train", device="cpu")()
    jm = MadrigalMultilabel(enc_cfg=enc(jc), prediction_dim=3,
                            prediction_dim_single_drug=4)
    v = init_multilabel(jm, jax.random.PRNGKey(0), bj.head, bj.tail, kj)
    assert "single_drug_head" in v["params"]
    want = np.asarray(jm.apply(v, bj.head, bj.tail, kj, train=False))
    want_single = np.asarray(jm.apply(
        v, bj.head, kj, method=MadrigalMultilabel.score_single_drug))
    # the config as a checkpoint reads it back: extra_tabular as dicts
    cfg = tc.from_dict(tc.EncoderConfig, tc.to_dict(enc(tc)))
    assert isinstance(cfg.extra_tabular["bs"], dict)
    tm = TM(cfg, 3, *kg_schema(dt.kg_node_feats, dt.kg_edge_indices),
            prediction_dim_single_drug=4)
    load_flax_weights(tm, v)  # strict: every tab_encoder_bs weight
    assert any(k.startswith("encoder.tab_encoder_bs.")
               for k in tm.state_dict())
    with torch.no_grad():
        got = tm.eval()(bt.head, bt.tail, kt).numpy()
        got_single = tm.score_single_drug(bt.head, kt).numpy()
    assert got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert got_single.shape == want_single.shape == (bt.head.batch_size, 4)
    np.testing.assert_allclose(got_single, want_single, atol=1e-5,
                               rtol=1e-5)
    print("BS_MODALITY_MATCHES")
""")


def test_extra_tabular_and_single_drug_match_jax():
    """The scores and score_single_drug of a model with the bs encoder
    and a single-drug head, carried from the JAX model's init."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert "BS_MODALITY_MATCHES" in res.stdout, (
        res.stdout[-2000:] + "\n" + res.stderr[-3000:])
