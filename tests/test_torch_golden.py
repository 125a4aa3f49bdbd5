"""The PyTorch port reproduces the frozen tiny model
(tests/golden/tiny_model_v1.npz): same config and synthetic data, the
JAX weights carried across with `interop/from_flax.py`, scores and z_raw
at atol 1e-5 as in test_golden_regression.py."""
import os

import numpy as np
import torch

from madrigal_tpu_torch.config import (
    ChemCPAConfig,
    EncoderConfig,
    FusionConfig,
    GINConfig,
    HGTConfig,
    MLPEncoderConfig,
    ProjectorConfig,
)
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "tiny_model_v1.npz")


def test_torch_port_reproduces_golden():
    enc = EncoderConfig(
        feature_dim=16, gin=GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        cv=MLPEncoderConfig(hidden_dims=(32, 16)),
        chemcpa=ChemCPAConfig(dim=16, autoencoder_width=32,
                              autoencoder_depth=1),
        transformer=FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                 ffn_dim=32, dropout=0.0, norm_first=True,
                                 agg="x-attn", num_tx_bottlenecks=2),
        proj=ProjectorConfig(hidden_dims=(32, 32), dropout=0.0),
        pos_emb_type="sinusoidal", pos_emb_dropout=0.0,
    )
    ds = make_dataset(num_drugs=12, num_labels=4, num_edges=16, seed=99)
    batch, kg = DDICollator(ds, split="train", device="cpu")()
    model = MadrigalMultilabel(enc, 4, *kg_schema(ds.kg_node_feats,
                                                  ds.kg_edge_indices))
    data = np.load(GOLDEN)
    load_flax_weights(model, {k: data[k] for k in data.files})
    model.eval()
    with torch.no_grad():
        scores = model(batch.head, batch.tail, kg).numpy()
        z_raw = model.encoder.encode(batch.head, kg=kg,
                                     raw_encoder_output=True).numpy()
    np.testing.assert_allclose(scores, data["scores"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(z_raw, data["z_raw"], atol=1e-5, rtol=1e-5)
