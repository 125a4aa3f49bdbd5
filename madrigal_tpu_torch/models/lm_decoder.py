"""LM decoder: zero-shot outcome generalization through text embeddings
(port of `madrigal_tpu/models/lm_decoder.py`; reference LM_decoder/
model.py:30-144 NovelDDILM): frozen Madrigal drug embeddings and a
language model's embeddings of the outcome descriptions (Mistral-7B 4096-d
or BERT 768-d) are projected into one space and scored by a concat-MLP or
by a 3-token self-attention block and an MLP.

The modules carry the flax module's names (`drug_project`, shared by head
and tail, `text_project`, `multihead_attn`, `out_dense1`, `out_dense2`),
so `interop/from_flax.lm_decoder_state_dict` carries JAX weights across.

Text embeddings arrive as precomputed vectors (an `.npy` file of
[num_outcomes, lm_dim], or a paraphrase bank [P, num_outcomes, lm_dim]);
`extract_text_embeddings` wraps transformers where its weights are on
the local disk.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiheadAttention


class LMDecoder(nn.Module):
    """Score (drug_head, drug_tail, outcome_text) triples."""

    def __init__(self, lm_emb_dim: int = 768, drug_dim: int = 128,
                 project_dim: int = 256, mlp_dim: int = 512,
                 dropout: float = 0.1, self_att: bool = True,
                 num_heads: int = 4, normalize: bool = False):
        super().__init__()
        self.dropout, self.self_att = dropout, self_att
        self.normalize = normalize
        # the reference shares one drug projection for head and tail
        # (LM_decoder/model.py:124-125)
        self.drug_project = nn.Linear(drug_dim, project_dim)
        self.text_project = nn.Linear(lm_emb_dim, project_dim)
        if self_att:
            self.multihead_attn = MultiheadAttention(project_dim, num_heads)
        self.out_dense1 = nn.Linear(3 * project_dim, mlp_dim)
        self.out_dense2 = nn.Linear(mlp_dim, 1)

    @classmethod
    def from_state_dict(cls, sd, num_heads: int = 4,
                        normalize: bool = False) -> "LMDecoder":
        """The decoder whose widths and self-attention choice `sd` (a
        saved state_dict) shows, holding `sd`, in eval mode on the CPU."""
        project, drug_dim = sd["drug_project.weight"].shape
        model = cls(lm_emb_dim=sd["text_project.weight"].shape[1],
                    drug_dim=drug_dim, project_dim=project,
                    mlp_dim=sd["out_dense1.weight"].shape[0],
                    self_att="multihead_attn.q_proj.weight" in sd,
                    num_heads=num_heads, normalize=normalize)
        model.load_state_dict(sd, strict=True)
        return model.eval()

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        """flax's Dropout: keep with probability 1 - rate and scale by its
        inverse, the mask drawn from `generator` (None: torch's global
        generator)."""
        if not self.training or self.dropout == 0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.dropout
        return x * keep / (1.0 - self.dropout)

    def forward(self, z_head: torch.Tensor, z_tail: torch.Tensor,
                text_embeddings: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """z_head/z_tail: [B, drug_dim] frozen Madrigal embeddings;
        text_embeddings: [B, lm_emb_dim] outcome-description embeddings.
        Returns [B] logits. In train mode the dropout masks come from
        `generator`."""
        if self.normalize:
            z_head = z_head / torch.linalg.norm(z_head, dim=-1, keepdim=True)
            z_tail = z_tail / torch.linalg.norm(z_tail, dim=-1, keepdim=True)
        zh = self._drop(F.silu(self.drug_project(z_head)), generator)
        zt = self._drop(F.silu(self.drug_project(z_tail)), generator)
        zx = self._drop(F.silu(self.text_project(text_embeddings)), generator)
        if self.self_att:
            seq = torch.stack([zx, zh, zt], dim=1)  # [B, 3, D]
            attn = self.multihead_attn(seq, seq, seq)
            feats = attn.reshape(attn.shape[0], -1)  # the 3 tokens, concat
        else:
            feats = torch.cat([zx, zh, zt], dim=-1)
        h = self._drop(F.silu(self.out_dense1(feats)), generator)
        return self.out_dense2(h)[:, 0]


PARAPHRASE_TEMPLATES = (
    "{}",
    "The interaction may result in: {}",
    "Co-administration can cause {}",
    "Risk of {} when the two drugs are combined",
    "Combining these drugs is associated with {}",
    "{} (adverse drug-drug interaction)",
    "Observed outcome of the drug pair: {}",
    "This drug combination can lead to {}",
    "Clinical effect reported for the pair: {}",
    "Potential for {} with concomitant use",
)


def build_paraphrase_bank(texts, num_variants: int = 10,
                          model_name: str = "bert-base-uncased",
                          embed_fn=None):
    """[P, L, lm_dim] paraphrase-variant embedding bank.

    The reference generates 10 GPT paraphrases per outcome description
    via the OpenAI API (LM_decoder/openai_api_request_parallel_processor.
    py + data.py:48-69); with no API egress this builds deterministic
    template variants instead and embeds each set -- same bank shape and
    training/eval semantics (one variant sampled per row per step).
    Pass reference-generated paraphrase CSVs through
    `extract_text_embeddings` per column to reproduce the original bank.
    """
    if embed_fn is None:
        embed_fn = lambda ts: extract_text_embeddings(ts, model_name)
    banks = []
    for p in range(num_variants):
        tmpl = PARAPHRASE_TEMPLATES[p % len(PARAPHRASE_TEMPLATES)]
        banks.append(embed_fn([tmpl.format(t) for t in texts]))
    return np.stack(banks)


def extract_text_embeddings(texts, model_name: str = "bert-base-uncased",
                            device: str = "cpu"):
    """Mean-pooled last-hidden-state embeddings via transformers
    (LM_decoder/embeddings.py:16 analog). Requires model weights locally;
    raises a clear error otherwise (no network is used)."""
    try:
        from transformers import AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_name,
                                            local_files_only=True)
        mdl = AutoModel.from_pretrained(model_name, local_files_only=True)
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            f"text-embedding extraction needs local weights for "
            f"{model_name}: {e}"
        )
    out = []
    with torch.no_grad():
        for t in texts:
            enc = tok(t, return_tensors="pt", truncation=True)
            h = mdl(**enc).last_hidden_state[0]
            out.append(h.mean(0).numpy())
    return np.stack(out)
