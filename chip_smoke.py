"""Smoke run of the PyTorch port (`madrigal_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `madrigal_tpu_torch/csrc/` into
`build/kernels/`, holds each against its plain PyTorch version on the
card, times it, and then drives the ported paths of the flagship DDI
model (TWOSIDES `sweep_config_hardy_sweep_321`: 128-d embeddings, GIN
128x3+128, 2-layer 4-head HGT, chemCPA 128 with a 512x2 autoencoder,
2-layer 8x256 norm-first x-attn fusion with 2 tx bottlenecks) with random
weights from a seed: serving at 6,843 drugs, 960 outcomes and the
PrimeKG-scale synthetic KG through `madrigal_tpu_torch.cli.predict` and
`madrigal_tpu_torch.eval.predict.score_all_pairs`; the normalized-rank
export of the same model through `madrigal_tpu_torch.eval.ranks.rank_tensor`
for RANK_CHUNK of its 960 outcomes at all 6,843 drugs; the two-checkpoint
ensemble through the serving CLI on the reference scale divided by
ENSEMBLE_SHRINK; stage-3 training, with its evaluation sweep and test
pass, through `madrigal_tpu_torch.cli.train_ddi` on the same data
(divided by SYNTHETIC_TRAIN_SHRINK) with the memory flags
TRAIN_MEMORY_FLAGS; stage-1 pretraining of each modality encoder
through `madrigal_tpu_torch.cli.modality_pretrain` (kg's link prediction
at full scale, str, cv and tx at the reference scale divided by
STAGE1_SHRINK); stage-2 contrastive pretraining of the flagship encoder,
warm-started from those four checkpoints, through
`madrigal_tpu_torch.cli.pretrain` at full scale, and with
its final-embeddings evaluation at the reference scale divided by
FINAL_EMBEDS_SHRINK; and stage 3 at full scale on the data written in
the reference's on-disk layout (`--data_dir`), warm-started from that
stage-2 run's checkpoint, with `--all_train` and the serving CLI on that
layout.

Phases, in order; any failure ends the script with a non-zero exit:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: kernels K1 (`csrc/bilinear.cu`) and K2 (`csrc/segment_sum.cu`)
     with nvcc for sm_90a, the two compiles started together;
  3. kernels: K1 and K2 against their plain versions at ragged shapes
     and at the shapes the paths give them (K2: every edge type the
     full-scale training run and the stage-1 kg run reduce in the source
     gathers' backward, and the sums K2 carries besides, k2_sum_checks:
     the 128-wide messages f32 and bf16 and the 4-wide softmax
     denominators at ppi, the molecule batch's sums and readout, a hub
     segment and a Zipf-like draw; the source gathers of one training
     step, 15 launches, and of one stage-1 kg step, 34), timed with CUDA
     events beside the plain version, one PyTorch call computing the same
     function (`library_ms`, timed only here), `index_add_` (the sums the
     port ran before K2 carried them) and the card's bound;
  4. small: the serving path on a small dataset on the card against the
     same model on the CPU;
  5. serving: the serving path at full width, with every kernel's launch
     count set to 0 just before it and read just after; a second KG pass
     and drug encoding in this process, whose embeddings must equal the
     CLI's bit for bit; then the bf16 throughput export (score_all_pairs
     with compute_dtype=bfloat16) on the same model, with its own
     launches and its chunks checked;
  6. ranks: rank_tensor on the serving model for RANK_CHUNK outcomes at
     all 6,843 drugs (counts set to 0 before, read after), and again on
     the second KG pass's embeddings, equal; K1's scores
     and the per-outcome rank timed apart; every outcome's layout; two
     outcomes against a numpy float32 form of the JAX package's compiled
     formula, exactly, and against the float64 offline path within
     2.5e-7, and a tie case against the numpy stable formula, exactly
     (these references run on the host beside the phases after it, and
     the ranks line follows theirs);
  6x. parallel_small: `parallel.dryrun`'s ranks (PARALLEL_RANKS,
     sharing the card through gloo; NCCL refuses a shared card): the JAX
     dryrun's seven sharded paths at its widths, each against one rank
     (the dryrun raises on a failed check), each path's launches a rank;
  6a. alt_small: the alternative encoders (ALT_ENCODERS: gat/hgt,
     gin/han, gin/rgcn) and gat/hgt with both compute types at bf16, at
     narrow_config's widths on ALT_SMALL_DRUGS drugs, ALT_SMALL_STEPS
     training steps on the card against the CPU (float32 losses within
     1e-4 relative, bf16 within BF16_LOSS_RTOL), K2's launches and the
     dtype of its rows (bf16 in the bf16 run);
  6b. alt_encoders: each of ALT_ENCODERS at full width (the reference's
     GAT, HAN and RGCN defaults with the flagship's fusion and decoder):
     the training CLI at the reference scale / ALT_SHRINK for one epoch,
     the serving CLI on its checkpoint exporting every score through K1,
     ALT_HEADS_VS_CPU drugs' scores against the CPU, and the serving
     phase's full-scale cut (128 heads x 6,843 x 960) on that phase's
     dataset with random weights (`kg_pass`, `drug_encode`, `scoring`
     and K1's share of it); counts set to 0 before each, read after;
  6c. bf16_train: one full-scale stage-3 step of the flagship with both
     compute types at bf16 and the HGT remat (peak memory, seconds, 15
     K2 launches on bf16 rows), then K2 on that step's bf16 ppi rows
     against its plain version, timed beside `torch.segment_reduce` and
     the bytes bound;
  6d. reference_ckpt: an upstream Madrigal finetune state_dict at the
     flagship's widths (PyG 2.3 HGT, softmax_scope='global') made here
     from seeded weights, converted by
     `interop.from_flax.state_dict_from_reference` back to every weight
     it came from, served at full scale through K1 and held to the CPU
     on ALT_HEADS_VS_CPU drugs; the same encoder as a stage-2 state_dict
     through `stage2_checkpoint_from_reference` into the stage-3 warm
     start, exactly;
  7. predict_ensemble: the serving CLI with two checkpoints at the
     reference scale / ENSEMBLE_SHRINK (counts set to 0 before, read
     after) exporting ranks, sigmoid-mean scores, the embeddings and
     triple probabilities; from the embeddings, each seed's K1 scores
     against the plain version, the scores against the plain sigmoid
     mean, the ranks against numpy's gmean re-rank of each seed's numpy
     ranks, and the seed files gone;
  7a. analyze: the analysis CLI (`madrigal_tpu_torch.cli.analyze`) over
     that phase's exported ranks (mmap): the self-combo diagonal, pairs,
     a gmean aggregate's top-k with a known mask, an enrichment, a binary
     validation and its cross-validated AUROC, against numpy on the same
     mmap, with no scikit-learn, pandas or pyyaml loaded;
  7b. parallel: the multi-GPU paths at flagship widths (phase_parallel):
     the 2-rank label-sharded ranks of phase 6's outcomes, equal to its
     ranks; a shard_finetune_trainer step at the reference scale /
     PARALLEL_SHRINK on meshes 2 x 1 and 1 x 2, the KG replicated and
     edge-sharded, and a dp-2 shard_cl_pretrainer step, within 1e-4
     relative of the one-card steps; the one-card step's successor run
     twice from the same state, equal bit for bit (repeat_step);
     `cli.predict --sharded` through torchrun on phase 7's checkpoints,
     its ranks and embeddings equal to phase 7's unsharded run's; the
     ranks and steps again as a one-rank NCCL group; each part's
     seconds, each rank's launches and peak memory (counts set to 0
     before each part, read after);
  8. train_small: 3 training steps at flagship widths (dropout 0) on a
     small dataset, on the card against the CPU from the same weights and
     masks, under AdamW (with the Evaluator's val metrics after them),
     RAdam and LARS, and the card's HGT gradients through K2 against
     those through the plain `index_add_` backward (`--no_src_mxu`);
  9. pretrain_small: PRETRAIN_SMALL_STEPS stage-2 steps at narrow widths
     (dropout 0) on a small dataset, on the card against the CPU from the
     same weights and host draws, on the device-table path under AdamW
     and LARS and the host-collate path under AdamW, and the card's HGT
     gradients through K2 against the plain backward's;
 10. stage1_small: STAGE1_SMALL_STEPS steps of each stage-1 trainer at
     narrow widths (dropout 0) on a small dataset, on the card against
     the CPU from the same weights and host inputs: GIN property
     prediction, HGT link prediction, the tabular autoencoder, chemCPA
     adaptation with its adversaries (the double backward of the
     gradient penalty, the alternating steps) and the frozen drug table;
     and the card's HGT gradients through K2 against the plain backward's;
 10a. chemcpa_sweep: the sweep CLI (`madrigal_tpu_torch.cli.chemcpa_sweep`)
     on a JSON file of two configs at the flagship chemCPA widths, on the
     tx rows of SWEEP_DRUGS drugs: each config's best R2, the best
     checkpoint onto the flagship encoder, and the card's memory after
     the second config's cleanup against the first's;
 11. training: the training CLI at the flagship configuration on the
     reference scale / SYNTHETIC_TRAIN_SHRINK for 3 epochs with one
     evaluation sweep and the test pass, with every kernel's launch count
     set to 0 just before it and read just after;
 11x. lm_decoder: the LM-head CLI (`madrigal_tpu_torch.cli.train_lm`) at
     full width on phase 5's checkpoint and embeddings, with a seeded
     paraphrase bank at Mistral-7B's width, LM_EPOCHS epochs; the drug
     table against those embeddings, the loss falling, the saved head on
     the CPU against the card;
 11a. profile: `utils.profiling.trace` (torch.profiler) around one K1
     call at the serving shape and one training step at phase 11's
     shapes: each trace names its kernel's symbol; the top device
     operations and the device's busy share of each; StepTimer over
     PROFILE_STEPS steps; memory_stats();
 12. stage1: the stage-1 CLI at the flagship encoder's widths: kg at the
     full reference scale (seed 0) for STAGE1_KG_EPOCHS full-graph steps
     (K2 at the link split's message-edge shapes, launches a step; the
     link split's, the KG build's and each step's seconds, the peak
     device memory), str, cv and tx (batch STAGE1_TX_BATCH, with the
     disentanglement probe) at the reference scale / STAGE1_SHRINK for
     STAGE1_EPOCHS steps, each run's counts set to 0 before and read
     after; each checkpoint's keys against the encoder subtree it
     overlays;
 13. pretrain: the stage-2 CLI at the flagship encoder's widths on the
     reference scale (seed 0), warm-started from phase 12's four
     checkpoints (`--modality_ckpts`; the encoder before the first step
     against their tensors, exactly), for PRETRAIN_STEPS steps of batch
     PRETRAIN_BATCH with a checkpoint every PRETRAIN_SAVE_EVERY (counts
     set to 0 before, read after; K2 at this run's shapes, launches a
     step; each step's seconds, the peak device memory), its checkpoints
     checked;
 13a. pretrain_embeds: `analysis.pretrain_embeds.pretrain_embedding_shift`
     between the encoder phase 13 started from and its `cl_last`, for
     EMBED_DRUGS drugs, and EMBED_DRUGS_VS_CPU drugs' rows against the CPU;
 14. pretrain_final_embeds: the stage-2 CLI with --host_collate and
     --final_embeds_eval at the reference scale / FINAL_EMBEDS_SHRINK
     for FINAL_EMBEDS_STEPS steps (counts set to 0 before, read after);
 15. data_dir: the reference-scale dataset written in the reference
     layout by the port's exporter (val/test tables of the 80/10/10
     split beside the train table), and the training CLI on that
     directory warm-started from phase 13's `cl_last` (`--data_dir
     --checkpoint --use_pretrained_adaptor`, RAdam) for 2 epochs, one
     sweep and the test pass (counts set to 0 before, read after): the
     data it loaded against the dataset written (every array but the
     molecules, exactly), the native featurizer's molecules against the
     built-in one's, the model the trainer received against the
     stage-2 checkpoint and the fresh init, exactly; then the serving
     CLI with `--data_dir` on the trained model, its triples against the
     exported embeddings;
 16. all_train: the training CLI with `--all_train` on reference-format
     data at the reference scale / ALL_TRAIN_SHRINK for one epoch (counts
     set to 0 before, read after).

Every path's K2 launches are held to the count its encoder passes need
(K2Expect: each KG or molecule encoder's forward sums, and the transposes
of its gathers where a gradient reaches it, derived from the code); the
paths that run no encoder launch none.

Standard output: one JSON line per phase, a line of each phase's wall
seconds (with the stage-2 phases' sum, the stage-1 phases' sum, the
sum of phases 6a-6d, the sum of phases 7a, 10a, 11x, 11a and 13a, the
sum of phases 6x and 7b, and `main` against STAGE2_BUDGET_S,
STAGE1_BUDGET_S, ALT_BUDGET_S, AUX_BUDGET_S, PARALLEL_BUDGET_S and
MAIN_BUDGET_S), the
`{"kernels": [...]}` line,
the nvidia-smi line, and last `{"ok": true, "device": {...}}`. The script
writes only under `build/` in the checkout and imports no JAX.

    python3 chip_smoke.py --train_memory

instead runs 2 epochs of the training run under each choice of memory
flags (MEMORY_CHOICES), each in a process of its own, and prints one
line per choice with its epoch times and peak device memory, or its
out-of-memory error. It prints no ok line.

    python3 chip_smoke.py --kernels

runs phases 1-3 only (device, build with nvcc's -Xptxas -v report, and
the kernel checks and timings) and prints their lines, with no
`{"kernels": [...]}` line and no ok line: the quick loop for kernel work.

    python3 chip_smoke.py --pretrain

builds K2 and runs phases 9, 13 (without the stage-1 warm start) and
14 only: the quick loop for stage-2 work. It prints no ok line.

    python3 chip_smoke.py --stage1

builds K2 and runs phases 10 and 12 only: the quick loop for stage-1
work. It prints no ok line.

    python3 chip_smoke.py --alt

builds both kernels, the reference-scale dataset, and runs phases 6a-6d
only: the quick loop for the alternative encoders, the bf16 modes and
the reference's checkpoints. It prints no ok line.

    python3 chip_smoke.py --parallel

builds both kernels and runs phases 6x and 7b only, with their own
references (a seeded table of NUM_DRUGS drugs and RANK_CHUNK outcomes
ranked by rank_tensor; the ensemble's checkpoints and their unsharded
export): the quick loop for multi-GPU work. It prints no ok line.
(`--parallel_rank DIR` is one of phase 7b's ranks, started by the
script itself.)

    python3 chip_smoke.py --aux

builds both kernels and runs phases 7a, 10a, 11x, 11a and 13a only, on
what `aux_setup` makes at the sizes `main` gives them (a flagship
checkpoint and its embeddings, a seeded rank tensor of the ensemble's
shape, two seeded flagship encoders): the quick loop for the sweep, the
LM head, analysis and profiling. It prints no ok line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import io
import json
import logging
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import madrigal_tpu_torch
from madrigal_tpu_torch import config as C
from madrigal_tpu_torch.cli import common as cli_common
from madrigal_tpu_torch.cli import modality_pretrain as cli_stage1
from madrigal_tpu_torch.cli import predict as cli_predict
from madrigal_tpu_torch.cli import pretrain as cli_pretrain
from madrigal_tpu_torch.cli import train_ddi as cli_train_ddi
from madrigal_tpu_torch.cli.common import reference_scale_kwargs
from madrigal_tpu_torch.data import datasets, native_featurizer
from madrigal_tpu_torch.data import kg as kg_lib
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.featurize import _rdkit_available, featurize_many
from madrigal_tpu_torch.data.kg import PAD_MULTIPLE, build_kg_batch, kg_schema
from madrigal_tpu_torch.data.molgraph import pack_molecules
from madrigal_tpu_torch.data.synthetic import (
    make_dataset,
    make_reference_scale_dataset,
    make_split_dataset,
    reference_scale_kg_sizes,
)
from madrigal_tpu_torch.device import resolve_device
from madrigal_tpu_torch.eval import predict as P
from madrigal_tpu_torch.eval import ranks as R
from madrigal_tpu_torch.eval.evaluate import Evaluator
from madrigal_tpu_torch.data.kg import edge_key
from madrigal_tpu_torch.models.chemcpa import ChemCPAEncoder
from madrigal_tpu_torch.models.encoder import (
    MadrigalEncoder,
    build_model,
    init_weights,
)
from madrigal_tpu_torch.models.gat import GATEncoder
from madrigal_tpu_torch.models.gin import GINEncoder
from madrigal_tpu_torch.models.hgt import HGTEncoder
from madrigal_tpu_torch.models.kg_alt import HANEncoder, RGCNEncoder
from madrigal_tpu_torch.ops import _build, bilinear, segment_sorted
from madrigal_tpu_torch.ops import gather as gather_lib
from madrigal_tpu_torch.train import checkpoint as ckpt_lib
from madrigal_tpu_torch.train import finetune, pretrain_cl
from madrigal_tpu_torch.train import modality_pretrain as stage1_lib
from madrigal_tpu_torch.train.checkpoint import (
    CL_TRANSFER_DROP_TOP,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
from madrigal_tpu_torch.train.finetune import FinetuneTrainer
from madrigal_tpu_torch.train.pretrain_cl import (
    CLPretrainer,
    build_simclr_model,
)

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
D = 128

# NVIDIA H100 SXM data sheet: HBM rate, dense tensor-core bf16 rate, and
# the float32 rate outside the tensor cores (float32 work here uses no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.float16: "f16"}

# the serving run: outcomes scored per K1 launch, and head drugs scored
NUM_DRUGS, NUM_LABELS, LABEL_CHUNK, SERVE_HEADS = 6843, 960, 64, 128
TRIPLES = ["0:1:2", "5:10:20"]

# the full-scale training runs (--data_dir, and --train_memory's): the
# reference scale divided by TRAIN_SHRINK (chosen on the card: the
# smallest of 1, 2, 4 whose peak memory fits in 80 GB), and the memory
# flags: the fastest of MEMORY_CHOICES that fits (`--train_memory`; with
# none a full-scale step asks for more than 80 GB), which recomputes each
# HGT edge type's messages in the backward. The --synthetic_scale
# training run: the reference scale divided by SYNTHETIC_TRAIN_SHRINK (the
# --data_dir run trains the full scale) for TRAIN_EPOCHS epochs
TRAIN_SHRINK, SYNTHETIC_TRAIN_SHRINK, TRAIN_EPOCHS = 1, 8, 3
TRAIN_MEMORY_FLAGS = ["--set", "model.encoder.hgt.remat_edge_types=true"]
# one evaluation sweep (after epoch index 2 of 0-2) and the test pass
TRAIN_EVAL_INTERVAL = 2
# the rank export: outcomes ranked (of 960; all 960 at 6,843 drugs are
# 180 GB of f32, the chunk 6.0 GB); the ensemble CLI's scale divisor
# (855 drugs, 120 outcomes: 0.35 GB a rank tensor) and label chunk
RANK_CHUNK = 32
ENSEMBLE_SHRINK, ENSEMBLE_CHUNK = 8, 32
ENSEMBLE_TRIPLES = ["0:1:2", "7:100:3", "119:854:0"]
# the reference-format run: epochs of the --data_dir training run (one
# evaluation sweep after the second, then the test pass), its optimizer,
# and the scale divisor and epochs of the --all_train run
DATA_DIR_EPOCHS, DATA_DIR_OPTIMIZER = 2, "radam"
ALL_TRAIN_SHRINK, ALL_TRAIN_EPOCHS = 8, 1
# train_small's RAdam and LARS runs: steps (RAdam at beta2 0.999 passes
# its rectification threshold at step 6)
OPTIM_STEPS = 7
# stage 2 (`cli.pretrain`): the full-scale run's steps, checkpoint
# interval and batch (the JAX package's measured stage-2 configuration,
# docs/CLI_WALL.md), whether it recomputes the HGT's edge types in the
# backward (no: the step fits in 80 GB without), pretrain_small's steps,
# and the --final_embeds_eval run's scale divisor and steps
PRETRAIN_STEPS, PRETRAIN_SAVE_EVERY, PRETRAIN_BATCH = 12, 5, 768
PRETRAIN_HGT_REMAT = False
PRETRAIN_SMALL_STEPS = 6
FINAL_EMBEDS_SHRINK, FINAL_EMBEDS_STEPS = 8, 2
# stage 1 (`cli.modality_pretrain`): the kg run's full-graph steps at
# the full reference scale (without HGT remat: the step fits in 80 GB);
# the str, cv and tx runs' scale divisor (their models do not depend on
# the data's size) and steps; tx's batch (the reference's,
# docs/STAGE1_SCALE.md); the share of each edge type's edges the link
# split holds out (make_link_split's `holdout`); and stage1_small's steps
# a trainer
STAGE1_KG_EPOCHS = 3
STAGE1_SHRINK, STAGE1_EPOCHS, STAGE1_TX_BATCH = 8, 5, 4096
LINK_HOLDOUT = 0.2
STAGE1_SMALL_STEPS = 4
# the alternative encoders (the reference's ablations; each a structure
# and a KG encoder) of alt_small and alt_encoders; alt_small's drugs and
# steps; the training and serving CLIs' scale divisor in alt_encoders; the
# drugs whose scores are held to the CPU; alt_small's bf16 loss tolerance
# (relative): bf16's unit roundoff, 2^-8
ALT_ENCODERS = (("gat", "hgt"), ("gin", "han"), ("gin", "rgcn"))
ALT_SMALL_DRUGS, ALT_SMALL_STEPS = 32, 3
ALT_SHRINK, ALT_HEADS_VS_CPU = 8, 8
BF16_LOSS_RTOL = 2.0 ** -8
# the wall-time budget: the stage-2 phases together, the stage-1 phases
# together, the four phases of the alternative encoders, the bf16 mode and
# the reference's checkpoints together (alt_small, alt_encoders,
# bf16_train, reference_ckpt), and main
STAGE2_BUDGET_S, STAGE1_BUDGET_S, ALT_BUDGET_S = 60.0, 60.0, 45.0
# the chemCPA sweep: its drugs (the reference's 6,843 / 8, as stage 1's
# tx run), the autoencoder rates of its two configs, its epochs, and how
# many bytes more the card may hold after the second config's cleanup
# than after the first's; the LM head: its paraphrase bank's variants and
# width (Mistral-7B's), epochs, batch, and the eval rows held to the CPU;
# analyze: the outcomes aggregated, the outcomes the cross-validated AUROC
# takes, and the top-k; pretrain_embeds: the drugs, and those held to the
# CPU; profile: the steps StepTimer times, and the device operations each
# trace lists; the wall-time budget of these five phases together
SWEEP_DRUGS, SWEEP_RATES, SWEEP_EPOCHS = 6843 // 8, (1e-3, 3e-4), 3
SWEEP_MEM_SLACK = 64 << 20
LM_VARIANTS, LM_DIM, LM_EPOCHS, LM_BATCH, LM_ROWS_VS_CPU = (
    10, 4096, 2, 512, 256)
ANALYZE_AGG_LABELS, ANALYZE_CV_LABELS, ANALYZE_TOPK = 3, 8, 20
EMBED_DRUGS, EMBED_DRUGS_VS_CPU = 10, 2
PROFILE_STEPS, TOP_DEVICE_OPS = 3, 10
AUX_BUDGET_S = 45.0
# the multi-GPU phases (parallel_small, parallel): ranks sharing the one
# card (gloo), the training data's scale divisor, the stage-2 batch (the
# full-scale run's, divided as the data is), and their wall-time budget
PARALLEL_RANKS, PARALLEL_SHRINK = 2, 8
PARALLEL_CL_BATCH = 768 // 8
PARALLEL_BUDGET_S = 75.0
MAIN_BUDGET_S = 520.0
# K2 reduces the fused k|v table of the 128-wide HGT; timed at the
# smallest edge type it reduces on the training path and at the largest
K2_WIDTH = 256
K2_TIMED = (("drug", "indication", "disease"), ("protein", "ppi", "protein"))
# K2 on every sum of the encoders: the HGT's messages and the HAN's and
# RGCN's (hidden 128), the softmax denominators (the flagship's 4 heads,
# and the GAT's and HAN's), the GIN's and GAT's molecule sums (128)
K2_MSG_WIDTH, K2_HEADS = 128, 4
# the skewed-degree checks: one segment with this share of ppi's rows, and
# a Zipf-like draw of exponent K2_ZIPF_A
K2_HUB_SHARE, K2_ZIPF_A = 0.25, 1.1
# the molecule batch of the serving path's drug encoding (embed_all_drugs)
K2_MOL_DRUGS = 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def flagship_config(num_labels: int, dropout: bool = True
                    ) -> C.TrainConfig:
    """The flagship configuration (upstream configs/ddi_finetune/TWOSIDES/
    sweep_config_hardy_sweep_321.yaml), at full width. dropout=False turns
    off every dropout that trains, so that two training runs draw no
    random numbers and can be compared."""
    p = 0.2 if dropout else 0.0  # the flagship's rate and the defaults'
    enc = C.EncoderConfig(
        feature_dim=128,
        gin=C.GINConfig(hidden_dims=(128, 128, 128), num_mlp_layer=3),
        hgt=C.HGTConfig(hidden_dim=128, num_layers=2, att_heads=4),
        cv=C.MLPEncoderConfig(dropout=p),
        chemcpa=C.ChemCPAConfig(dim=128, autoencoder_width=512,
                                autoencoder_depth=2, use_drugs=False),
        transformer=C.FusionConfig(
            num_layers=2, att_heads=8, head_dim=256, ffn_dim=1024,
            dropout=p, actn="gelu", norm_first=True, agg="x-attn",
            num_tx_bottlenecks=2),
        proj=C.ProjectorConfig(dropout=p),
        pos_emb_type="sinusoidal",
        pos_emb_dropout=p,
        fusion="transformer_uni_proj",
    )
    return C.TrainConfig(
        model=C.ModelConfig(encoder=enc, prediction_dim=num_labels),
        optim=C.OptimizerConfig(), finetune_mode="str_random_sample",
        num_epochs=10, warmup_epochs=2, seed=0)


def narrow_config(num_labels: int) -> C.TrainConfig:
    """The flagship's modules and options at narrow widths, dropout 0:
    train_small's optimizer runs, whose CPU side at full width would take
    most of the phase."""
    cfg = flagship_config(num_labels, dropout=False)
    enc = cfg.model.encoder
    enc = dataclasses.replace(
        enc, feature_dim=32,
        gin=C.GINConfig(hidden_dims=(32, 32), num_mlp_layer=2),
        hgt=dataclasses.replace(enc.hgt, hidden_dim=64),
        cv=dataclasses.replace(enc.cv, hidden_dims=(64, 32)),
        chemcpa=dataclasses.replace(enc.chemcpa, dim=32,
                                    autoencoder_width=64),
        transformer=dataclasses.replace(enc.transformer, num_layers=1,
                                        att_heads=2, head_dim=16,
                                        ffn_dim=64),
        proj=dataclasses.replace(enc.proj, hidden_dims=(64, 64)))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=enc))


def random_model(cfg: C.TrainConfig, ds, seed: int) -> torch.nn.Module:
    """The model for `ds`'s KG schema on the CPU, weights from `seed`."""
    model = build_model(cfg.model,
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    return init_weights(model, torch.Generator().manual_seed(seed))


# ------------------------------------------------------------------ K1
def k1_bound(L: int, M: int, N: int, compute: torch.dtype,
             out: torch.dtype):
    """(least time in ms, what bounds it) for one K1 call on the card:
    each input read once and each score written once, against the two
    products' operations at the compute type's peak rate."""
    cs = torch.finfo(compute).bits // 8
    os_ = torch.finfo(out).bits // 8
    nbytes = (M * D + N * D + L * D * D) * cs + L * M * N * os_
    ops = 2 * L * M * D * D + 2 * L * M * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[compute] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int) -> float:
    """Median device time of one call of `fn` in ms over `iters` calls,
    each between two CUDA events, after a warm-up call."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def max_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, max |ref|), one outcome at a time."""
    err = scale = 0.0
    for g, r in zip(got, ref):
        r = r.float()
        err = max(err, (g.float() - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
    return err, scale


def k1_inputs(L: int, M: int, N: int, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    zh = torch.randn(M, D, generator=g, device="cuda")
    zt = torch.randn(N, D, generator=g, device="cuda")
    w = torch.randn(L, D, D, generator=g, device="cuda") / D ** 0.5
    return zh.to(dtype), zt.to(dtype), w.to(dtype)


def k1_check(L, M, N, compute, out, seed=0, iters=0):
    """K1 against its plain version on the card: f32 compute and output
    within 1e-4 of max|plain| (the same f32 products, summed in another
    order), otherwise within 1e-2 (a bf16 rounding of ZW or of the score
    can land on the other side of its boundary). With iters, also time
    the kernel, the plain version and the one-call PyTorch yardstick."""
    zh, zt, w = k1_inputs(L, M, N, compute, seed)
    got = bilinear.bilinear_scores(zh, zt, w, out, compute)
    ref = bilinear.bilinear_scores_plain(zh, zt, w, out, compute)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    del got, ref
    tol = 1e-4 if compute == out == torch.float32 else 1e-2
    row = {"L": L, "M": M, "N": N, "compute": DTYPE_NAME[compute],
           "out": DTYPE_NAME[out], "iters": iters, "max_abs_err": err,
           "max_abs_plain": scale, "tol": tol * scale}
    require(np.isfinite(err) and err <= tol * scale,
            f"K1 disagrees with its plain version: {row}")
    if iters:
        row["ms"] = cuda_ms(
            lambda: bilinear.bilinear_scores(zh, zt, w, out, compute), iters)
        row["plain_ms"] = cuda_ms(
            lambda: bilinear.bilinear_scores_plain(zh, zt, w, out, compute),
            iters)
        # the yardstick: one PyTorch call chain over the same inputs, in
        # the compute type (the port never calls it)
        row["library_ms"] = cuda_ms(
            lambda: torch.matmul(torch.matmul(zh, w), zt.T), iters)
        row["bound_ms"], row["bound_by"] = k1_bound(L, M, N, compute, out)
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    f32, bf16 = torch.float32, torch.bfloat16
    checks = [k1_check(5, 300, 1000, c, o, seed=1)
              for c in (f32, bf16) for o in (f32, bf16)]
    # the f32 path's 128x128 tiles: ragged edges past one and two tiles,
    # one row against the serving width (N % 4 != 0: one-value stores),
    # and whole tiles with N % 4 == 0 (16-byte stores)
    checks += [k1_check(L, M, N, f32, o, seed=5)
               for L, M, N in ((3, 129, 257), (1, 1, NUM_DRUGS),
                               (2, 256, 1024))
               for o in (f32, bf16)]
    # the bf16 path's outcome groups and row-wise stores: L not a multiple
    # of the group, M not a multiple of 64, N odd, N % 8 == 2 and N % 8 ==
    # 0 (rows at every 2-byte offset, and aligned rows), and small M
    # against large N (the z_tail sweep split)
    checks += [k1_check(L, M, N, bf16, o, seed=7)
               for L, M, N in ((1, 65, NUM_DRUGS), (3, 100, 1002),
                               (5, 129, 1024), (6, 1, NUM_DRUGS),
                               (5, 63, 999))
               for o in (f32, bf16)]
    # the ensemble CLI's calls: ENSEMBLE_CHUNK outcomes over all its
    # drugs, and its last chunk's remainder
    ens = reference_scale_kwargs(ENSEMBLE_SHRINK)
    n_e, l_e = ens["num_drugs"], ens["num_labels"]
    checks.append(k1_check(ENSEMBLE_CHUNK, n_e, n_e, f32, f32, seed=6,
                           iters=21))
    if l_e % ENSEMBLE_CHUNK:
        checks.append(k1_check(l_e % ENSEMBLE_CHUNK, n_e, n_e, f32, f32,
                               seed=6))
    # the shape score_all_pairs gives K1 in the serving phase, and the
    # all-pairs export at one 64-outcome chunk; the bf16 export
    # (score_all_pairs' compute_dtype=bfloat16) at both; last bench.py's op
    checks.append(k1_check(LABEL_CHUNK, SERVE_HEADS, NUM_DRUGS, f32, f32,
                           seed=2, iters=50))
    checks.append(k1_check(LABEL_CHUNK, NUM_DRUGS, NUM_DRUGS, f32, f32,
                           seed=3, iters=11))
    # the rank export's chunk: RANK_CHUNK outcomes over all drugs, f32
    checks.append(k1_check(RANK_CHUNK, NUM_DRUGS, NUM_DRUGS, f32, f32,
                           seed=4, iters=11))
    checks.append(k1_check(LABEL_CHUNK, SERVE_HEADS, NUM_DRUGS, bf16, f32,
                           seed=2, iters=50))
    checks.append(k1_check(LABEL_CHUNK, NUM_DRUGS, NUM_DRUGS, bf16, f32,
                           seed=3, iters=11))
    checks.append(k1_check(LABEL_CHUNK, NUM_DRUGS, NUM_DRUGS, bf16, bf16,
                           seed=3, iters=21))
    for row in checks:
        emit({"phase": "kernels", "kernel": "bilinear_scores", **row})
    return checks


# ------------------------------------------------------------------ K2
def k2_bound(e_real: int, n: int, w: int, dtype: torch.dtype):
    """(least time in ms, what bounds it) for one K2 call on the card: the
    real rows read once, the f32 output and the boundary table written or
    read once, against one f32 add per input value."""
    nbytes = e_real * w * (torch.finfo(dtype).bits // 8) + n * w * 4 + (
        n + 1) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_real * w / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_inputs(e_real: int, e_pad: int, n: int, dtype: torch.dtype,
              seed: int, width: int = K2_WIDTH, draw: str = "uniform"):
    """[e_pad, width] rows grouped by a random segment id, rows past
    e_real trailing padding. `draw`: 'uniform' (as the synthetic KG's
    endpoints are; one segment left empty), 'hub' (one segment holds
    K2_HUB_SHARE of the rows, the rest uniform) or 'zipf' (segment k drawn
    with weight k^-K2_ZIPF_A, as skewed degrees are). The hub and Zipf
    rows hold small integers, whose f32 sums are exact in any order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if draw == "zipf":
        w = torch.arange(1, n + 1, device="cuda",
                         dtype=torch.float64) ** -K2_ZIPF_A
        ids = torch.multinomial(w, e_real, replacement=True, generator=g)
    else:
        ids = torch.randint(0, n, (e_real,), generator=g, device="cuda")
        if draw == "hub":
            ids[:int(e_real * K2_HUB_SHARE)] = n // 3
        else:
            ids[ids == n // 2] = n // 2 + 1  # one empty segment
    ids = ids.sort()[0]
    starts = torch.searchsorted(
        ids, torch.arange(n + 1, device="cuda")).to(torch.int32)
    if draw == "uniform":
        data = torch.randn(e_pad, width, generator=g, device="cuda")
    else:
        data = torch.randint(-8, 9, (e_pad, width), generator=g,
                             device="cuda").float()
    return data.to(dtype), starts


def k2_check(e_real, e_pad, n, dtype, seed=0, iters=0, width=K2_WIDTH,
             draw="uniform"):
    """k2_rows_check on k2_inputs' rows (hub and Zipf rows exactly)."""
    data, starts = k2_inputs(e_real, e_pad, n, dtype, seed, width, draw)
    row = k2_rows_check(data, starts, n, iters,
                        rtol=1e-5 if draw == "uniform" else 0.0)
    del data, starts
    torch.cuda.empty_cache()
    return row


def k2_rows_check(data, starts, n: int, iters: int = 0,
                  rtol: float = 1e-5) -> dict:
    """K2 on `data` [E, W] under `starts` against its plain version, within
    rtol of max|plain| (1e-5: the same f32 sums in another order; bf16
    rows widen to f32 exactly); two launches give the same bits. With
    iters, also time the kernel, the plain version, the one-call PyTorch
    yardstick and `index_add_` (the sums the port ran before K2 carried
    them, on the rows widened to f32), beside the bytes bound."""
    got = segment_sorted.sorted_segment_sum(data, starts, n)
    again = segment_sorted.sorted_segment_sum(data, starts, n)
    ref = segment_sorted.sorted_segment_sum_plain(data, starts, n)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    e_real = int(starts[-1])
    sizes = (starts[1:] - starts[:-1]).max().item() if n else 0
    row = {"E": data.shape[0], "E_real": e_real, "N": n, "W": data.shape[1],
           "in": DTYPE_NAME[data.dtype], "iters": iters, "max_abs_err": err,
           "max_abs_plain": scale, "tol": rtol * scale,
           "largest_segment": int(sizes),
           "repeatable": bool(torch.equal(got, again))}
    require(np.isfinite(err) and err <= rtol * scale and row["repeatable"],
            f"K2 disagrees with its plain version: {row}")
    del got, again, ref
    if iters:
        seg = segment_sorted.row_segments(starts, data.shape[0])
        wide = data.float()
        out = torch.zeros((n + 1, data.shape[1]), device=data.device)
        row["index_add_ms"] = cuda_ms(
            lambda: out.zero_().index_add_(0, seg, wide), iters)
        del seg, wide, out
        row["ms"] = cuda_ms(
            lambda: segment_sorted.sorted_segment_sum(data, starts, n), iters)
        row["plain_ms"] = cuda_ms(
            lambda: segment_sorted.sorted_segment_sum_plain(data, starts, n),
            iters)
        # the yardstick: one PyTorch call over the same rows (the port
        # never calls it)
        offsets = starts.long()
        row["library_ms"] = cuda_ms(
            lambda: torch.segment_reduce(data, "sum", offsets=offsets),
            iters)
        row["bound_ms"], row["bound_by"] = k2_bound(e_real, n, data.shape[1],
                                                    data.dtype)
    return row


def k2_shapes(shrink: int, link_split: bool = False) -> dict:
    """{edge type: (real rows, padded rows, source nodes)} of every K2
    launch in the training run at --synthetic_scale_shrink `shrink`: the
    edge types whose backward reaches the drug table (k2_live_edge_types),
    sized as the CLI's dataset builder sizes them, each padded to a
    multiple of 512 rows as the KG batch pads it. With `link_split`, those
    of the stage-1 kg run instead: every edge type, on the message edges
    its link split keeps."""
    kw = reference_scale_kwargs(shrink)
    nodes, edges = reference_scale_kg_sizes(kw.get("num_drugs", NUM_DRUGS),
                                            kw.get("kg_scale", 1))
    if link_split:
        edges = {et: e - max(1, int(e * LINK_HOLDOUT))
                 for et, e in edges.items()}
        live = set(edges)
    else:
        hgt = flagship_config(NUM_LABELS).model.encoder.hgt
        live = {et for layer in k2_live_edge_types(list(edges),
                                                   hgt.num_layers)
                for et in layer}
    return {et: (edges[et], -(-edges[et] // PAD_MULTIPLE) * PAD_MULTIPLE,
                 nodes[et[0]]) for et in edges if et in live}


def check_k2_shapes(edge_indices: dict, shrink: int, path: str,
                    link_split: bool = False) -> None:
    """The KG a run trained on gives K2 the edge counts that
    phase_k2_kernels checked it at for that run's scale (and, with
    `link_split`, for the stage-1 kg run's message edges)."""
    want = {et: shape[0]
            for et, shape in k2_shapes(shrink, link_split).items()}
    got = {et: edge_indices[et].shape[1] for et in want}
    require(got == want, f"{path}: the KG's live edge counts {got} are not "
            f"the ones K2 was checked at ({want})")


def phase_k2_kernels():
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # ragged: empty segments, trailing padding rows, N not a multiple of a
    # block's 8 segments; f32, bf16 and f16 rows
    checks = [k2_check(e_real, e_pad, n, dt, seed=4)
              for e_real, e_pad, n in ((900, 1000, 37), (4000, 4096, 1001))
              for dt in (f32, bf16, f16)]
    # every edge type the runs at the reference scale / 8 (--synthetic_scale
    # training, --all_train, stage 2's --final_embeds_eval run) reduce, at
    # the shape those runs give it
    for shrink in sorted({SYNTHETIC_TRAIN_SHRINK, ALL_TRAIN_SHRINK,
                          FINAL_EMBEDS_SHRINK} - {TRAIN_SHRINK}):
        for et, shape in k2_shapes(shrink).items():
            checks.append({"edge_type": "__".join(et), "shrink": shrink,
                           **k2_check(*shape, f32, seed=7)})
    # every edge type of the stage-1 kg run (full scale, the link split's
    # message edges), at the shape the run gives it; the largest timed
    for et, shape in k2_shapes(TRAIN_SHRINK, link_split=True).items():
        checks.append({"edge_type": "__".join(et), "shrink": TRAIN_SHRINK,
                       "path": "stage1",
                       **k2_check(*shape, f32, seed=9,
                                  iters=50 if et == K2_TIMED[-1] else 0)})
    # every edge type the full-scale training run (--data_dir) reduces, at
    # the shape the run gives it; the smallest and the largest timed (the
    # kernels line reports the last timed row, the largest)
    for et, shape in k2_shapes(TRAIN_SHRINK).items():
        checks.append({"edge_type": "__".join(et), "shrink": TRAIN_SHRINK,
                       **k2_check(*shape, f32, seed=6,
                                  iters=50 if et in K2_TIMED else 0)})
    timed = [r for r in checks if "ms" in r]
    require(timed[-1]["edge_type"] == "__".join(K2_TIMED[-1]),
            "the last timed K2 row is not the training run's largest")
    checks = k2_sum_checks() + checks  # the kernels line's main row last
    for row in checks:
        emit({"phase": "kernels", "kernel": "sorted_segment_sum", **row})
    emit({"phase": "kernels", "kernel": "sorted_segment_sum",
          "src_gather_per_step": k2_step(TRAIN_SHRINK),
          "src_gather_per_step_stage1": k2_step(TRAIN_SHRINK,
                                                link_split=True)})
    return checks


def k2_sum_checks() -> list:
    """K2 at the shapes of its uses beside the source gather's, each held
    to its plain version and timed: at the full-scale KG's largest edge
    type (ppi, dst-sorted), the messages of the HGT, HAN and RGCN (128
    wide, f32; bf16 for the bf16 HGT) and the softmax denominators (one
    column a head); at the smallest (drug-indication) the messages; over
    the serving path's molecule batch (K2_MOL_DRUGS drugs), the GIN's and
    GAT's message sums and readout (128 wide) and the GAT's
    denominators; and the skewed cases at ppi's size: one hub segment
    holding K2_HUB_SHARE of the rows, 128 and 4 wide, and a Zipf-like
    draw, 128 wide."""
    f32, bf16 = torch.float32, torch.bfloat16
    nodes, edges = reference_scale_kg_sizes()
    rows = []
    for et in (("protein", "ppi", "protein"), ("drug", "indication",
                                               "disease")):
        e = edges[et]
        e_pad = -(-e // PAD_MULTIPLE) * PAD_MULTIPLE
        uses = [("messages", K2_MSG_WIDTH, f32, "uniform")]
        if et[1] == "ppi":
            uses += [("messages_bf16", K2_MSG_WIDTH, bf16, "uniform"),
                     ("denominators", K2_HEADS, f32, "uniform"),
                     ("hub_messages", K2_MSG_WIDTH, f32, "hub"),
                     ("hub_denominators", K2_HEADS, f32, "hub"),
                     ("zipf_messages", K2_MSG_WIDTH, f32, "zipf")]
        for use, w, dt, draw in uses:
            # the skewed cases take tens of ms a launch: fewer repeats
            rows.append({"use": use, "edge_type": "__".join(et),
                         "draw": draw, **k2_check(
                             e, e_pad, nodes[et[2]], dt, seed=11,
                             iters=50 if draw == "uniform" else 5,
                             width=w, draw=draw)})
    mols = pack_molecules(make_dataset(num_drugs=K2_MOL_DRUGS,
                                       seed=0).molecules, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    n_pad = mols.num_nodes_padded
    for use, n_rows, w, starts, n in (
            ("mol_messages", mols.num_edges_padded, K2_MSG_WIDTH,
             mols.edge_dst_starts, n_pad),
            ("mol_denominators", mols.num_edges_padded, K2_HEADS,
             mols.edge_dst_starts, n_pad),
            ("mol_readout", n_pad, K2_MSG_WIDTH, mols.node_graph_starts,
             mols.num_graphs)):
        data = torch.randn(n_rows, w, generator=g, device="cuda")
        rows.append({"use": use, "drugs": K2_MOL_DRUGS,
                     **k2_rows_check(data, starts, n, iters=50)})
    del mols
    torch.cuda.empty_cache()
    return rows


def k2_step(shrink: int, link_split: bool = False) -> dict:
    """K2 over one training step (with `link_split`, one stage-1 kg step):
    every (HGT layer, live edge type) launch at the shape the run gives
    it, each timed alone, summed, and the sum of their bounds; beside it
    the plain version and one `torch.segment_reduce` call a launch, timed
    and summed the same way."""
    shapes = k2_shapes(shrink, link_split)
    hgt = flagship_config(NUM_LABELS).model.encoder.hgt
    layers = ([list(shapes)] * hgt.num_layers if link_split
              else k2_live_edge_types(list(shapes), hgt.num_layers))
    ms, plain, library, bound = {}, {}, {}, {}
    for et, (e_real, e_pad, n) in shapes.items():
        data, starts = k2_inputs(e_real, e_pad, n, torch.float32, seed=8)
        offsets = starts.long()
        ms[et] = cuda_ms(
            lambda: segment_sorted.sorted_segment_sum(data, starts, n), 20)
        plain[et] = cuda_ms(lambda: segment_sorted.sorted_segment_sum_plain(
            data, starts, n), 20)
        library[et] = cuda_ms(
            lambda: torch.segment_reduce(data, "sum", offsets=offsets), 20)
        bound[et] = k2_bound(e_real, n, K2_WIDTH, torch.float32)[0]
        del data, starts, offsets
    launches = [et for layer in layers for et in layer]
    return {"launches": len(launches),
            "ms": sum(ms[et] for et in launches),
            "plain_ms": sum(plain[et] for et in launches),
            "library_ms": sum(library[et] for et in launches),
            "bound_ms": sum(bound[et] for et in launches)}


# ------------------------------------------------------------- serving
class PhaseTimes(logging.Handler):
    """Collects the `phase` / `seconds` that eval.predict logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = {}

    def emit(self, record):
        if hasattr(record, "phase"):
            self.seconds[record.phase] = record.seconds


def phase_small():
    """The serving path on the card against the same model on the CPU, on
    a small dataset: within 1e-4 of max|cpu| (the same f32 math without
    TF32, summed in another order)."""
    ds = make_dataset(seed=3)
    cpu_model = random_model(flagship_config(ds.num_labels), ds, seed=1)
    triples = [(0, 1, 2), (5, 3, 4), (11, 30, 7)]
    res = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(cpu_model).to(dev)
        coll = DDICollator(ds, split="train", seed=0, device=dev)
        z = P.embed_all_drugs(model, coll, coll.kg_batch())
        res[dev] = (z, P.score_all_pairs(model, z),
                    P.score_triples_for_pairs(model, z, triples))
    errs = {}
    for name, got, ref in zip(("z", "scores", "triples"), res["cuda"],
                              res["cpu"]):
        require(got.shape == ref.shape and np.isfinite(got).all(),
                f"small serving run: {name} has shape {got.shape} or is "
                "not finite")
        errs[name] = float(np.abs(got - ref).max())
        require(errs[name] <= 1e-4 * np.abs(ref).max(),
                f"small serving run: {name} differs from the CPU run by "
                f"{errs[name]} (max|cpu| {np.abs(ref).max()})")
    emit({"phase": "small", "drugs": ds.num_drugs, "outcomes": ds.num_labels,
          "max_abs_err_vs_cpu": errs})


def phase_serving(seed: int = 0):
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    ckpt, emb = str(WORK / "flagship.pt"), str(WORK / "z.npy")
    t0 = time.perf_counter()
    ds = make_reference_scale_dataset(seed=seed)
    require((ds.num_drugs, ds.num_labels) == (NUM_DRUGS, NUM_LABELS),
            "the reference-scale dataset changed size")
    kg_edges = int(sum(e.shape[1] for e in ds.kg_edge_indices.values()))
    t_data = time.perf_counter() - t0
    # the KG batch build with the serving layouts (sorted by destination)
    # and with the source-sorted one of the training backward added (host
    # argsorts, and the copies to the card); the first is kept for the
    # second KG pass below
    t_kg = {}
    for layout, src_sort in (("sorted", False), ("src_sort", True)):
        t0 = time.perf_counter()
        kg = build_kg_batch(ds.kg_node_feats, ds.kg_edge_indices,
                            ds.kg_drug_ids, device="cuda", src_sort=src_sort)
        torch.cuda.synchronize()
        t_kg[layout] = time.perf_counter() - t0
        if src_sort:
            del kg
        else:
            kg_sorted = kg
    # K2's weak case is a destination with many edges: the synthetic KG's
    # largest in-degree per edge type
    in_degree = {"__".join(et): int(np.bincount(ei[1]).max())
                 for et, ei in ds.kg_edge_indices.items() if ei.shape[1]}
    save_checkpoint(ckpt, random_model(flagship_config(NUM_LABELS), ds, seed),
                    flagship_config(NUM_LABELS))

    times = PhaseTimes()
    logging.getLogger("madrigal_tpu_torch").addHandler(times)
    logging.getLogger("madrigal_tpu_torch").setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    triple_scores = cli_predict.main([
        "--checkpoint", ckpt, "--synthetic_scale", "--seed", str(seed),
        "--platform", "cuda", "--export_embeddings", emb,
        "--label_chunk", str(LABEL_CHUNK), "--triples", *TRIPLES])
    t_cli = time.perf_counter() - t0
    z = np.load(emb)
    model, _ = P.model_from_checkpoint(ckpt, device="cuda")
    scores = P.score_all_pairs(model, z[:SERVE_HEADS], z,
                               label_chunk=LABEL_CHUNK)
    counts = read_launches()  # counts end here
    k2_want = require_k2(counts, "serving")
    launches = counts["bilinear_scores"]
    t_main = time.perf_counter() - t0
    phase_s = dict(times.seconds)
    # a second KG pass and drug encoding in this process, on the same
    # weights and data: the same bits as the CLI's
    t0 = time.perf_counter()
    z_again = P.embed_all_drugs(
        model, DDICollator(ds, split="train", device="cuda"), kg_sorted)
    t_again = time.perf_counter() - t0
    del kg_sorted
    require(np.array_equal(z_again, z),
            f"two KG passes and drug encodings differ by "
            f"{float(np.abs(z_again - z).max())}")

    require(z.shape == (NUM_DRUGS, D) and np.isfinite(z).all(),
            f"embeddings: shape {z.shape} or not finite")
    require(scores.shape == (NUM_LABELS, SERVE_HEADS, NUM_DRUGS)
            and np.isfinite(scores).all(),
            f"scores: shape {scores.shape} or not finite")
    n_chunks = -(-NUM_LABELS // LABEL_CHUNK)
    require(launches == n_chunks,
            f"K1 launched {launches} times in the serving run, "
            f"expected {n_chunks}")
    # first and last chunk against K1's plain version on the same inputs
    w_sym = P.decoder_weight(model)
    zh = torch.from_numpy(z[:SERVE_HEADS]).cuda()
    zt = torch.from_numpy(z).cuda()
    chunk_err = 0.0
    for s in (0, NUM_LABELS - LABEL_CHUNK):
        ref = bilinear.bilinear_scores_plain(
            zh, zt, w_sym[s:s + LABEL_CHUNK], torch.float32,
            torch.float32).cpu().numpy()
        err = float(np.abs(scores[s:s + LABEL_CHUNK] - ref).max())
        require(err <= 1e-4 * np.abs(ref).max(),
                f"score chunk at outcome {s} differs from the plain "
                f"version by {err}")
        chunk_err = max(chunk_err, err)
    # the CLI's triple answers (plain per-triple path) against K1's scores
    want = [scores[l, a, b] for l, a, b in
            (map(int, t.split(":")) for t in TRIPLES)]
    triple_err = float(np.abs(np.asarray(triple_scores) - want).max())
    require(triple_err <= 1e-4 * np.abs(scores).max(),
            f"triple answers differ from the score tensor by {triple_err}")
    del scores
    bf16_export = serve_bf16_export(model, z, zh, zt, w_sym, n_chunks)
    logging.getLogger("madrigal_tpu_torch").removeHandler(times)
    bf16_export["scoring_s"] = times.seconds["scoring"]
    emit({"phase": "serving", "drugs": NUM_DRUGS, "outcomes": NUM_LABELS,
          "kg_edges": kg_edges, "label_chunk": LABEL_CHUNK,
          "head_drugs": SERVE_HEADS, "launches": counts,
          "k2_expected": k2_want, "max_in_degree": in_degree,
          "chunk_max_abs_err": chunk_err, "triple_max_abs_err": triple_err,
          "second_pass": {"equal_bits": True, "s": t_again},
          "data_build_s": t_data, "kg_build_s": t_kg, "cli_s": t_cli,
          "main_path_s": t_main,
          "phase_s": phase_s, "bf16_export": bf16_export,
          "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # the checkpoint and the embeddings stay for the lm_decoder phase
    return counts, model, z, ds, ckpt, emb, z_again


def serve_bf16_export(model, z, zh, zt, w_sym, n_chunks: int) -> dict:
    """The throughput export, score_all_pairs(compute_dtype=bfloat16), on
    the serving run's model and embeddings: n_chunks more K1 launches, and
    its first and last chunk against K1's plain version at bf16 compute
    within 1e-2 of max|plain| (k1_check's tolerance)."""
    before = read_launches()["bilinear_scores"]
    scores = P.score_all_pairs(model, z[:SERVE_HEADS], z,
                               label_chunk=LABEL_CHUNK,
                               compute_dtype=torch.bfloat16)
    launches = read_launches()["bilinear_scores"] - before
    require(launches == n_chunks,
            f"K1 launched {launches} times in the bf16 export, expected "
            f"{n_chunks}")
    require(scores.shape == (NUM_LABELS, SERVE_HEADS, NUM_DRUGS)
            and np.isfinite(scores).all(),
            f"bf16 export: shape {scores.shape} or not finite")
    chunk_err = 0.0
    for s in (0, NUM_LABELS - LABEL_CHUNK):
        ref = bilinear.bilinear_scores_plain(
            zh, zt, w_sym[s:s + LABEL_CHUNK], torch.float32,
            torch.bfloat16).cpu().numpy()
        err = float(np.abs(scores[s:s + LABEL_CHUNK] - ref).max())
        require(err <= 1e-2 * np.abs(ref).max(),
                f"bf16 export chunk at outcome {s} differs from the plain "
                f"version by {err}")
        chunk_err = max(chunk_err, err)
    return {"launches": launches, "chunk_max_abs_err": chunk_err}


# --------------------------------------------------------------- ranks
def np_rank_levels(m: int) -> np.ndarray:
    """The values of a normalized-rank triangle, ascending: float32(k) + 1
    times float32(1) / float32(m), k = 0..m-1 (the JAX package's compiled
    formula: XLA turns its division by m into this product)."""
    return ((np.arange(m, dtype=np.float32) + np.float32(1))
            * (np.float32(1) / np.float32(m)))


def np_rank_lower(scores: np.ndarray) -> np.ndarray:
    """The strict lower triangle (row-major) of the normalized-rank matrix
    of `scores` in numpy float32: the stable argsort of the triangle's
    scores, its inverse permutation (what the reference's second argsort
    computes), then np_rank_levels."""
    n = scores.shape[0]
    rows, cols = np.tril_indices(n, -1)
    order = np.argsort(scores[rows, cols], kind="stable")
    out = np.empty(order.shape[0], np.float32)
    out[order] = np_rank_levels(order.shape[0])
    return out


def check_rank_layout(r: torch.Tensor, levels: torch.Tensor,
                      rows: torch.Tensor, cols: torch.Tensor) -> None:
    """One outcome's rank matrix on the card: symmetric, zero diagonal,
    and the strict lower triangle a permutation of `levels`."""
    require(torch.equal(r, r.T), "a rank matrix is not symmetric")
    require(bool((torch.diagonal(r) == 0).all()),
            "a rank matrix has a nonzero diagonal")
    require(torch.equal(torch.sort(r[rows, cols]).values, levels),
            "a rank triangle is not a permutation of {1..m}/m")


def phase_ranks(model, z: np.ndarray, z_again: np.ndarray):
    """rank_tensor on the serving model for RANK_CHUNK outcomes at every
    drug (one K1 launch, then one rank a outcome), into host memory, and
    every outcome's layout on the card; the same rank tensor from the
    serving phase's second KG pass (`z_again`), equal. The references for two outcomes
    and a tie case (numpy float32 in threads, the float64 offline path in
    its process pool) start here and run on beside the next phases.
    Returns the path's launch counts and the function that waits for the
    references, holds the ranks to them and prints the phase's line."""
    work = WORK / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    n = z.shape[0]
    m = n * (n - 1) // 2
    w_sym = P.decoder_weight(model)[:RANK_CHUNK].contiguous()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    ranks = R.rank_tensor(z, w_sym, chunk=RANK_CHUNK, device="cuda")
    t_main = time.perf_counter() - t0
    counts = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(counts == {"bilinear_scores": 1, "sorted_segment_sum": 0},
            f"rank path launches {counts}, expected K1 once")
    require(ranks.shape == (RANK_CHUNK, n, n), f"ranks {ranks.shape}")
    t0 = time.perf_counter()
    again = R.rank_tensor(z_again, w_sym, chunk=RANK_CHUNK, device="cuda")
    t_again = time.perf_counter() - t0
    require(same_ranks(again, ranks), "the rank tensors of two KG passes "
            "differ")
    del again

    # K1's scores for the chunk and one outcome's rank, timed apart
    zc = torch.from_numpy(z).cuda()
    k1_ms = cuda_ms(lambda: bilinear.bilinear_scores(
        zc, zc, w_sym, torch.float32, torch.float32), 5)
    scores = bilinear.bilinear_scores(zc, zc, w_sym, torch.float32,
                                      torch.float32)
    order_idx = R.lower_tri_order(n, False, "cuda")  # once a chunk
    rank_ms = cuda_ms(lambda: R.rank_lower(scores[0], order_idx, True), 5)
    del order_idx

    # the references: two outcomes in numpy float32 (exactly) and on the
    # float64 offline path (within 2.5e-7: m > 2^24, so the float32 ranks
    # round), and a tie case in numpy
    picked = (0, RANK_CHUNK - 1)
    raw = np.stack([scores[l].cpu().numpy() for l in picked])
    ties = torch.round(scores[0] * 2) / 2
    n_values = int(torch.unique(ties).numel())
    tie_ranks = R.normalized_rank_matrix(ties).cpu().numpy()
    ties = ties.cpu().numpy()
    del scores
    torch.cuda.empty_cache()
    raw_path, off_path = str(work / "raw.npy"), str(work / "offline.npy")
    np.save(raw_path, raw)
    t_refs = time.perf_counter()
    pool = ThreadPoolExecutor(4)
    refs = [pool.submit(np_rank_lower, x) for x in (*raw, ties)]
    offline = pool.submit(R.normalize_scores_offline, raw_path, off_path, 2)
    pool.shutdown(wait=False)

    # every outcome's layout, on the card
    rows, cols = torch.tril_indices(n, n, -1, device="cuda")
    levels = torch.from_numpy(np_rank_levels(m)).cuda()
    for r in ranks:
        check_rank_layout(torch.from_numpy(r).cuda(), levels, rows, cols)
    del rows, cols, levels

    def finish() -> None:
        ref = [f.result() for f in refs]
        off = np.asarray(offline.result())
        lo = np.tril_indices(n, -1)
        off_err = 0.0
        for i, l in enumerate(picked):
            require(np.array_equal(ranks[l][lo], ref[i]),
                    f"outcome {l}: ranks differ from the numpy float32 "
                    "formula")
            off_err = max(off_err, float(np.abs(ranks[l] - off[i]).max()))
        require(off_err <= 2.5e-7,
                f"ranks differ from the float64 offline path by {off_err}")
        require(np.array_equal(tie_ranks[lo], ref[2])
                and np.array_equal(tie_ranks, tie_ranks.T),
                "tie case: ranks differ from the numpy stable formula")
        emit({"phase": "ranks", "drugs": n, "outcomes": RANK_CHUNK,
              "of_outcomes": NUM_LABELS,
              "host_gb": RANK_CHUNK * n * n * 4 / 1e9,
              "launches": counts, "rank_tensor_s": t_main,
              "second_pass_equal": True, "second_pass_s": t_again,
              "k1_chunk_ms": k1_ms, "rank_ms_per_outcome": rank_ms,
              "checked_exact_outcomes": list(picked),
              "max_abs_err_vs_offline_f64": off_err,
              "tie_case_distinct_values": n_values,
              "reference_s": time.perf_counter() - t_refs,
              "peak_device_mem_gb": peak})
        shutil.rmtree(work)

    return counts, finish, ranks, w_sym.cpu().numpy()


def ensemble_argv(ckpts) -> list:
    """The serving CLI's arguments for the ensemble's checkpoints at the
    reference scale / ENSEMBLE_SHRINK (predict_ensemble, and the sharded
    export of the parallel phase)."""
    return ["--checkpoint", *ckpts, "--synthetic_scale",
            "--synthetic_scale_shrink", str(ENSEMBLE_SHRINK), "--seed", "0",
            "--platform", "cuda", "--label_chunk", str(ENSEMBLE_CHUNK),
            "--eval_type", "str+kg_full"]


def ensemble_checkpoints(work: Path) -> tuple:
    """The ensemble's two flagship checkpoints (seeds 0 and 1) for the
    reference scale / ENSEMBLE_SHRINK, under `work`: (paths, each one's
    symmetrized decoder weight on the card, drugs, outcomes)."""
    ds = make_reference_scale_dataset(
        seed=0, **reference_scale_kwargs(ENSEMBLE_SHRINK))
    cfg = flagship_config(ds.num_labels)
    ckpts, w_syms = [], []
    for seed in (0, 1):
        model = random_model(cfg, ds, seed)
        ckpts.append(str(work / f"seed{seed}.pt"))
        save_checkpoint(ckpts[-1], model, cfg)
        w_syms.append(P.decoder_weight(model).cuda())
    return ckpts, w_syms, ds.num_drugs, ds.num_labels


def phase_predict_ensemble() -> dict:
    """The serving CLI with two checkpoints (seeds 0 and 1) on the
    reference scale divided by ENSEMBLE_SHRINK, exporting ranks (seed
    files not kept), sigmoid-mean scores, the embeddings and triple
    probabilities. The references start from the exported embeddings and
    each seed's decoder weight: each seed's K1 scores again (launches not
    counted), within K1's tolerance of the plain version; the exported
    scores within 1e-5 of the sigmoid mean of the plain scores; the
    exported ranks equal to numpy's ranks (np_rank_lower) of the gmean of
    each seed's numpy ranks of its K1 scores."""
    from scipy.stats import gmean

    work = WORK / "ensemble"
    work.mkdir(parents=True, exist_ok=True)
    ckpts, w_syms, n, L = ensemble_checkpoints(work)
    out = {k: str(work / f"{k}.npy") for k in ("ranks", "scores", "z")}
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    probs = np.asarray(cli_predict.main(ensemble_argv(ckpts) + [
        "--export_ranks", out["ranks"],
        "--export_scores", out["scores"], "--export_embeddings", out["z"],
        "--triples", *ENSEMBLE_TRIPLES]))
    t_cli = time.perf_counter() - t0
    counts = read_launches()  # counts end here
    chunks = -(-L // ENSEMBLE_CHUNK)
    require(counts["bilinear_scores"] == 4 * chunks,
            f"ensemble launches {counts}, expected 2 seeds x {chunks} "
            "chunks for the ranks and as many for the scores")
    k2_want = require_k2(counts, "predict_ensemble")
    left = sorted(p.name for p in work.glob("ranks.npy.seed*"))
    require(not left, f"seed files {left} left without --keep_seed_ranks")

    t0 = time.perf_counter()
    z = torch.from_numpy(np.load(out["z"])).cuda()
    require(z.shape == (2, n, D), f"embeddings {tuple(z.shape)}")
    f32 = torch.float32
    mean = torch.zeros(L, n, n, device="cuda")
    k1_err, seed_ranks = 0.0, []
    lo = np.tril_indices(n, -1)
    with ThreadPoolExecutor(8) as pool:
        for zs, w in zip(z, w_syms):
            got = bilinear.bilinear_scores(zs, zs, w, f32, f32)
            plain = bilinear.bilinear_scores_plain(zs, zs, w, f32, f32)
            err, scale = max_err(got, plain)
            require(err <= 1e-4 * scale,
                    f"ensemble: K1 differs from its plain version by {err} "
                    f"(max |plain| {scale})")
            k1_err = max(k1_err, err)
            mean += torch.sigmoid(plain)
            seed_ranks.append([pool.submit(np_rank_lower, s)
                               for s in got.cpu().numpy()])
            del got, plain
        scores = torch.from_numpy(np.load(out["scores"])).cuda()
        score_err = (scores - mean / 2).abs().max().item()
        require(score_err <= 1e-5,
                f"ensemble scores differ from the plain sigmoid mean by "
                f"{score_err}")
        del scores, mean
        # each seed's ranks in the seed file's layout (symmetric, zero
        # diagonal), their gmean, and its re-rank
        mats = np.zeros((2, L, n, n), np.float32)
        for i, futures in enumerate(seed_ranks):
            for l, f in enumerate(futures):
                mats[i, l][lo] = f.result()
        mats += mats.transpose(0, 1, 3, 2)
        with np.errstate(divide="ignore"):
            g = np.asarray(gmean(mats, axis=0), np.float32)
        del mats
        refs = list(pool.map(np_rank_lower, g))
    ens = np.load(out["ranks"])
    require(ens.shape == (L, n, n), f"ensemble ranks {ens.shape}")
    for l in range(L):
        require(np.array_equal(ens[l][lo], refs[l])
                and np.array_equal(ens[l], ens[l].T),
                f"ensemble ranks of outcome {l} differ from numpy's")
    # the triple probabilities against the exported sigmoid-mean scores
    scores = np.load(out["scores"], mmap_mode="r")
    want = [scores[l, a, b] for l, a, b in
            (map(int, t.split(":")) for t in ENSEMBLE_TRIPLES)]
    triple_err = float(np.abs(probs - want).max())
    require(triple_err <= 1e-5 and ((0 < probs) & (probs < 1)).all(),
            f"triple probabilities differ from the scores by {triple_err}")
    del scores, ens, g
    emit({"phase": "predict_ensemble", "shrink": ENSEMBLE_SHRINK,
          "drugs": n, "outcomes": L, "seeds": 2,
          "label_chunk": ENSEMBLE_CHUNK, "launches": counts, "cli_s": t_cli,
          "k2_expected": k2_want, "k1_max_abs_err_vs_plain": k1_err,
          "scores_max_abs_err_vs_plain": score_err,
          "triple_probs": probs.tolist(), "triple_max_abs_err": triple_err,
          "reference_s": time.perf_counter() - t0})
    # the directory stays for the analyze phase, which reads the ranks
    return counts, Path(out["ranks"])


# ------------------------------------------------------------ parallel
def parallel_pretrain_config(enc) -> C.PretrainConfig:
    """The parallel phase's stage-2 configuration: the flagship encoder
    (dropout 0, so the dp step's draws are the one card's) with the
    stage-2 settings of `pretrain_argv`, batch PARALLEL_CL_BATCH."""
    return C.PretrainConfig(
        encoder=enc, pretrain_mode="str_center_uni",
        pretrain_unbalanced=True, raw_encoder_output=True,
        pretrain_batch_size=PARALLEL_CL_BATCH, seed=0)


def parallel_data():
    """The parallel phase's training data: the reference scale /
    PARALLEL_SHRINK, its collated batch and KG (K2's layout) on the card,
    and the flagship configuration (dropout 0) for its outcomes."""
    ds = make_reference_scale_dataset(
        seed=0, **reference_scale_kwargs(PARALLEL_SHRINK))
    coll = DDICollator(ds, split="train", device="cuda", kg_src_sort=True)
    batch, kg = coll()
    return ds, coll, batch, kg, flagship_config(ds.num_labels, dropout=False)


def parallel_steps(work: Path, ds, coll, batch, kg, cfg, meshes) -> dict:
    """One finetune step from `work`/ft.pt on each (dp, label, KG axis) of
    `meshes` and one stage-2 step from `work`/cl.pt (device table, dp over
    every rank), on this rank; each with its losses, seconds and launch
    counts (set to 0 just before the step, read just after)."""
    from madrigal_tpu_torch.parallel.mesh import make_mesh
    from madrigal_tpu_torch.parallel.train_step import (
        make_train_mesh, shard_cl_pretrainer, shard_finetune_trainer)

    schema = kg_schema(ds.kg_node_feats, ds.kg_edge_indices)
    out = {}
    for dp, label, axis in meshes:
        t0 = time.perf_counter()
        model = build_model(finetune.training_model_config(cfg), *schema,
                            device="cuda")
        model.load_state_dict(torch.load(work / "ft.pt"))
        trainer = FinetuneTrainer(cfg, batch, kg, model)
        shard_finetune_trainer(trainer, make_train_mesh(label_dim=label),
                               kg_shard_axis=axis)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        losses = trainer.train_epoch()
        torch.cuda.synchronize()
        name = f"finetune_{dp}x{label}_kg_{axis or 'replicated'}"
        out[name] = {"losses": losses, "s": time.perf_counter() - t0,
                     "setup_s": setup_s,
                     "launches": read_launches()}  # counts end here
        out[name]["k2_expected"] = require_k2(out[name]["launches"], name)
        del trainer, model
    t0 = time.perf_counter()
    pcfg = parallel_pretrain_config(cfg.model.encoder)
    model = build_simclr_model(pcfg, *schema).cuda()
    model.load_state_dict(torch.load(work / "cl.pt"))
    trainer = CLPretrainer(pcfg, coll, kg, model)
    shard_cl_pretrainer(trainer, make_mesh(("dp",)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    loss = trainer.train_step()
    out["stage2_dp"] = {"loss": loss, "s": time.perf_counter() - t0,
                        "setup_s": setup_s,
                        "launches": read_launches()}  # counts end here
    out["stage2_dp"]["k2_expected"] = require_k2(
        out["stage2_dp"]["launches"], "stage2_dp")
    del trainer, model
    torch.cuda.empty_cache()
    return out


def repeat_step(trainer) -> dict:
    """The trainer's next step run twice from the same state: weights and
    statistics, optimizer and schedule state, the mask sampler and the
    generators' states. The two give the same losses, parameters, buffers
    and optimizer state, bit for bit. Returns each run's seconds and the
    tensors compared."""
    state = {"model": copy.deepcopy(trainer.model.state_dict()),
             "optimizer": copy.deepcopy(trainer.optimizer.state_dict()),
             "scheduler": copy.deepcopy(trainer.scheduler.state_dict()),
             "masker": copy.deepcopy(trainer.masker), "epoch": trainer.epoch,
             "cpu_rng": torch.get_rng_state(),
             "cuda_rng": torch.cuda.get_rng_state()}
    runs, seconds = [], []
    for _ in range(2):
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        trainer.scheduler.load_state_dict(state["scheduler"])
        trainer.masker = copy.deepcopy(state["masker"])
        trainer.epoch = state["epoch"]
        torch.set_rng_state(state["cpu_rng"])
        torch.cuda.set_rng_state(state["cuda_rng"])
        t0 = time.perf_counter()
        losses = trainer.train_epoch()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        opt = trainer.optimizer.state_dict()["state"]
        runs.append((losses, {k: v.clone() for k, v in
                              trainer.model.state_dict().items()},
                     [t.clone() for st in opt.values() for t in st.values()
                      if isinstance(t, torch.Tensor)]))
    (l1, m1, o1), (l2, m2, o2) = runs
    differ = ([k for k in m1 if not torch.equal(m1[k], m2[k])]
              + [f"optimizer state {i}" for i, (a, b) in enumerate(zip(o1, o2))
                 if not torch.equal(a, b)])
    require(l1 == l2 and not differ and len(o1) == len(o2) > 0,
            f"a training step run twice from the same state differs: "
            f"losses {l1} and {l2}; {differ[:8]}")
    return {"s": seconds, "losses": l1, "tensors": len(m1) + len(o1)}


def parallel_rank(work: Path) -> int:
    """One rank of the parallel phase's group (`chip_smoke.py
    --parallel_rank DIR`, started by `parallel.dryrun.launch` with
    torchrun's variables; gloo, as the ranks share one card): the
    label-sharded ranks of `work`'s z and w into `work`/ranks.npy, then
    `parallel_steps` on meshes 2 x 1 and 1 x 2, the KG replicated and
    edge-sharded. Rank 0 writes every rank's results to
    `work`/results.json."""
    import torch.distributed as dist

    from madrigal_tpu_torch.parallel import allpairs, multihost
    from madrigal_tpu_torch.parallel.collectives import all_gather_object
    from madrigal_tpu_torch.parallel.dryrun import prewarm_optimizer_import
    from madrigal_tpu_torch.parallel.mesh import make_mesh

    t_start = time.perf_counter()
    prewarm_optimizer_import()  # beside the ranks part
    multihost.initialize(device="cuda", backend="gloo")
    rank = dist.get_rank()
    res = {"init_s": time.perf_counter() - t_start}
    z, w = np.load(work / "z.npy"), np.load(work / "w.npy")
    out = (np.lib.format.open_memmap(
        work / "ranks.npy", mode="w+", dtype=np.float32,
        shape=(w.shape[0], z.shape[0], z.shape[0])) if rank == 0 else None)
    mesh = make_mesh(("label",))
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    allpairs.sharded_rank_tensor(mesh, z, w,
                                 chunk_per_device=w.shape[0] // 2, out=out)
    res["ranks"] = {"s": time.perf_counter() - t0,
                    "launches": read_launches()}  # counts end here
    if out is not None:
        out.flush()
        del out
    t0 = time.perf_counter()
    data = parallel_data()
    res["data_s"] = time.perf_counter() - t0
    res.update(parallel_steps(work, *data, meshes=[
        (2, 1, None), (2, 1, "dp"), (1, 2, None), (1, 2, "dp")]))
    res["peak_device_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["rank_s"] = time.perf_counter() - t_start
    every = all_gather_object(res)
    if rank == 0:
        (work / "results.json").write_text(json.dumps(every))
    multihost.shutdown()
    return 0


def phase_parallel_small() -> dict:
    """`python -m madrigal_tpu_torch.parallel.dryrun --nproc 2 --device
    cuda --backend gloo`: the JAX dryrun's seven sharded paths at its
    widths on 2 ranks sharing the card, each held to the same work done
    on one rank (the dryrun raises on a failed check). Returns the launch
    counts summed over the paths and ranks."""
    from madrigal_tpu_torch.parallel import dryrun

    torch.cuda.empty_cache()  # the card is the ranks' now
    t0 = time.perf_counter()
    # the ranks `python -m madrigal_tpu_torch.parallel.dryrun --nproc 2
    # --device cuda --backend gloo` starts, started from this process
    ranks = dryrun.launch(
        [sys.executable, "-m", "madrigal_tpu_torch.parallel.dryrun",
         "--worker", "--device", "cuda", "--backend", "gloo"],
        PARALLEL_RANKS, timeout=300, cwd=ROOT)
    for r in ranks:
        require(r.returncode == 0, f"parallel dryrun rank {r.rank} exited "
                f"{r.returncode}:\n{r.stderr[-4000:]}")
    line = json.loads([l for l in ranks[0].stdout.splitlines()
                       if l.startswith("{")][-1])
    require(line.get("dryrun") == "ok" and len(line["paths"]) == 7,
            f"parallel dryrun: {line}")
    counts = {"bilinear_scores": 0, "sorted_segment_sum": 0}
    for path in line["paths"].values():
        for per_rank in path["launches"]:
            for k in counts:
                counts[k] += per_rank[k]
    # K1 scores each block of path 2's outcomes on both ranks; K2 carries
    # the sums of every path that runs an encoder, the graph-parallel ones
    # (4-6) on each rank's share (the exact counts a step are checked in
    # the parallel phase), and none of the rank path's
    k1 = -(-dryrun.NUM_LABELS
           // (PARALLEL_RANKS * dryrun.RANK_CHUNK_PER_DEVICE))
    require(all(r["bilinear_scores"] == k1
                for r in line["paths"]["2_ranks"]["launches"])
            and all(r["sorted_segment_sum"] == 0
                    for r in line["paths"]["2_ranks"]["launches"])
            and all(r["sorted_segment_sum"] > 0
                    for p, path in line["paths"].items() if p != "2_ranks"
                    for r in path["launches"]),
            f"parallel dryrun launches: {line['paths']}")
    emit({"phase": "parallel_small", "ranks": line["nproc"],
          "backend": line["backend"],
          "paths": {k: {"err": v["err"], "tol": v["tol"], "s": v["s"],
                        "launches": v["launches"]}
                    for k, v in line["paths"].items()},
          "ranks_s": line["seconds"], "command_s": time.perf_counter() - t0,
          "peak_device_mem_gb": [b / 1e9 for b in line["peak_bytes"]],
          "launches": counts})
    return counts


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def same_ranks(got, want) -> bool:
    """Exact equality of two [L, N, N] rank tensors, outcome by outcome
    (either may be an np.memmap)."""
    return got.shape == want.shape and all(
        np.array_equal(got[l], want[l]) for l in range(want.shape[0]))


def phase_parallel(ranks_ref: np.ndarray, z: np.ndarray, w: np.ndarray,
                   ens: Path) -> dict:
    """The multi-GPU paths at the flagship's widths, the ranks sharing
    the card through gloo:
      (a) sharded_rank_tensor over 2 ranks for the ranks phase's
          RANK_CHUNK outcomes of `w` at all of `z`'s drugs, equal to that
          phase's `ranks_ref`;
      (b) one shard_finetune_trainer step on the reference scale /
          PARALLEL_SHRINK, meshes 2 x 1 and 1 x 2, the KG replicated (K2
          launched a step on each rank) and edge-sharded (K2 0 times),
          losses within 1e-4 relative of the one-card step from the same
          weights and masks;
      (c) one device-table shard_cl_pretrainer step, dp 2, against the
          one-card step;
      (d) `torchrun --nproc_per_node=2 -m madrigal_tpu_torch.cli.predict
          --sharded` on the ensemble's checkpoints in `ens`, its ranks
          equal to the unsharded ranks of its own embeddings
          (check_sharded_cli), and set beside that directory's unsharded
          run;
      (e) (a) and (b) again in this process as a one-rank NCCL group.
    (d) starts first; (a)-(c) run in two spawned ranks (`parallel_rank`)
    beside it, the one-card references and (e) here meanwhile."""
    from madrigal_tpu_torch.parallel import allpairs, multihost
    from madrigal_tpu_torch.parallel.dryrun import free_port, launch
    from madrigal_tpu_torch.parallel.mesh import make_mesh

    work = WORK / "parallel"
    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()  # the card is shared with the ranks
    t_phase = time.perf_counter()
    pool = ThreadPoolExecutor(2)
    ckpts = [str(ens / f"seed{s}.pt") for s in (0, 1)]
    cli = pool.submit(
        subprocess.run,
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(PARALLEL_RANKS), "--master_port", str(free_port()), "-m",
         "madrigal_tpu_torch.cli.predict", *ensemble_argv(ckpts),
         "--sharded", "--backend", "gloo", "--export_ranks",
         str(work / "cli_ranks.npy"), "--export_embeddings",
         str(work / "cli_z.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    np.save(work / "z.npy", z)
    np.save(work / "w.npy", w)
    t0 = time.perf_counter()
    ds, coll, batch, kg, cfg = parallel_data()
    data_s = time.perf_counter() - t0
    model = random_model(cfg, ds, seed=3)
    torch.save(model.state_dict(), work / "ft.pt")
    pcfg = parallel_pretrain_config(cfg.model.encoder)
    cl_model = init_weights(build_simclr_model(
        pcfg, *kg_schema(ds.kg_node_feats, ds.kg_edge_indices)),
        torch.Generator().manual_seed(4))
    torch.save(cl_model.state_dict(), work / "cl.pt")

    t0 = time.perf_counter()
    ranks_job = pool.submit(
        launch, [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--parallel_rank", str(work)], PARALLEL_RANKS,
        timeout=300, cwd=ROOT)
    pool.shutdown(wait=False)

    # the one-card references, meanwhile, and the next step run twice
    # from the same state
    trainer = FinetuneTrainer(cfg, batch, kg, model.cuda())
    t1 = time.perf_counter()
    ref = trainer.train_epoch()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    repeat = repeat_step(trainer)
    del trainer, model
    trainer = CLPretrainer(pcfg, coll, kg, cl_model.cuda())
    ref_cl = trainer.train_step()
    del trainer, cl_model
    torch.cuda.empty_cache()

    # (e) a one-rank NCCL group in this process, beside the ranks
    t_e = time.perf_counter()
    multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1,
                         rank=0, device="cuda", backend="nccl")
    try:
        reset_launches()  # counts start here
        t1 = time.perf_counter()
        nccl_ranks = allpairs.sharded_rank_tensor(
            make_mesh(("label",)), z, w, chunk_per_device=w.shape[0])
        nccl = {"ranks": {"s": time.perf_counter() - t1,
                          "launches": read_launches()}}  # counts end here
        require(same_ranks(nccl_ranks, ranks_ref),
                "one-rank NCCL sharded ranks differ from the ranks phase's")
        del nccl_ranks
        nccl.update(parallel_steps(work, ds, coll, batch, kg, cfg,
                                   [(1, 1, None), (1, 1, "dp")]))
    finally:
        multihost.shutdown()
    nccl_err = max([rel_err(nccl[m]["losses"][k], v) for k, v in ref.items()
                    for m in nccl if m.startswith("finetune_")]
                   + [rel_err(nccl["stage2_dp"]["loss"], ref_cl)])
    require(nccl_err <= 1e-4, f"one-rank NCCL losses differ from the "
            f"one-card step's by {nccl_err} relative")
    nccl_s = time.perf_counter() - t_e

    ranks_res = ranks_job.result()
    spawned_s = time.perf_counter() - t0
    for r in ranks_res:
        require(r.returncode == 0, f"parallel rank {r.rank} exited "
                f"{r.returncode}:\n{r.stderr[-4000:]}")
    per_rank = json.loads((work / "results.json").read_text())
    got = np.load(work / "ranks.npy", mmap_mode="r")
    require(same_ranks(got, ranks_ref),
            "2-rank sharded ranks differ from the ranks phase's")
    del got
    worst = 0.0
    for res in per_rank:
        require(res["ranks"]["launches"] == {"bilinear_scores": 1,
                                             "sorted_segment_sum": 0},
                f"sharded ranks launches {res['ranks']['launches']}")
        for key, run in res.items():
            if not key.startswith("finetune_"):
                continue
            for k, v in ref.items():
                worst = max(worst, rel_err(run["losses"][k], v))
        worst = max(worst, rel_err(res["stage2_dp"]["loss"], ref_cl))
    require(worst <= 1e-4, f"2-rank losses differ from the one-card step's "
            f"by {worst} relative")

    cli_res = cli.result()
    cli_s = time.perf_counter() - t_phase
    require(cli_res.returncode == 0, f"sharded predict CLI failed:\n"
            f"{cli_res.stderr[-4000:]}")
    cli_log = cli_res.stderr.strip().splitlines()[-12:]
    cli_check = check_sharded_cli(work, ckpts, ens)


    counts = {"bilinear_scores": 0, "sorted_segment_sum": 0}
    for res in per_rank + [nccl]:
        for key, run in res.items():
            if isinstance(run, dict) and "launches" in run:
                for k in counts:
                    counts[k] += run["launches"][k]
    emit({"phase": "parallel", "ranks": PARALLEL_RANKS, "backend": "gloo",
          "shrink": PARALLEL_SHRINK, "drugs": ds.num_drugs,
          "outcomes": ds.num_labels, "rank_outcomes": int(w.shape[0]),
          "rank_drugs": int(z.shape[0]),
          "per_rank": per_rank, "one_card": {"losses": ref, "s": ref_s,
                                             "stage2_loss": ref_cl,
                                             "repeated_step": repeat},
          "max_rel_loss_err": worst, "nccl_one_rank": nccl,
          "nccl_max_rel_loss_err": nccl_err, "data_s": data_s,
          "spawned_s": spawned_s, "cli_s": cli_s, "cli": cli_check,
          "cli_log_tail": cli_log,
          "nccl_s": nccl_s,
          "phase_s": time.perf_counter() - t_phase, "launches": counts})
    shutil.rmtree(work)
    return counts


def check_sharded_cli(work: Path, ckpts, ens: Path) -> dict:
    """The --sharded CLI's ranks against the unsharded CLI's functions
    (each seed's rank_tensor at ENSEMBLE_CHUNK, then
    ensemble_normalized_ranks) on the embeddings that run exported, and
    against the unsharded CLI's own run in `ens`: equal, and its
    embeddings equal that run's. Each run's KG pass sums on K2 in a fixed
    order, so the two runs' embeddings have the same bits, and so have
    their ranks."""
    z = np.load(work / "cli_z.npy")
    got = np.load(work / "cli_ranks.npy", mmap_mode="r")
    seeds = []
    for zs, path in zip(z, ckpts):
        model, _ = P.model_from_checkpoint(path, device="cuda")
        seeds.append(R.rank_tensor(zs, P.decoder_weight(model),
                                   chunk=ENSEMBLE_CHUNK, device="cuda"))
        del model
    want = R.ensemble_normalized_ranks(seeds, chunk=ENSEMBLE_CHUNK,
                                       device="cuda")
    require(same_ranks(got, want), "the --sharded CLI's ranks differ from "
            "the unsharded ranks of its own embeddings")
    other = np.load(ens / "ranks.npy", mmap_mode="r")
    out = {"equal_to_unsharded_of_same_embeddings": True,
           "entries_differing_from_unsharded_run": int(
               sum((got[l] != other[l]).sum() for l in range(len(got)))),
           "max_abs_diff_vs_unsharded_run": float(max(
               np.abs(got[l] - other[l]).max() for l in range(len(got)))),
           "z_max_abs_diff_vs_unsharded_run": float(
               np.abs(z - np.load(ens / "z.npy")).max())}
    require(out["entries_differing_from_unsharded_run"] == 0
            and out["z_max_abs_diff_vs_unsharded_run"] == 0.0,
            f"the --sharded CLI's export differs from the unsharded run's: "
            f"{out}")
    return out


def parallel_reference(work: Path) -> tuple:
    """`--parallel`'s own references: a seeded [NUM_DRUGS, D] table and
    RANK_CHUNK outcomes of a seeded flagship decoder, ranked on the card
    by rank_tensor; the ensemble's checkpoints and their unsharded ranks
    through the serving CLI (ranks only). Returns (ranks, z, w, ensemble
    directory)."""
    rng = np.random.RandomState(0)
    z = rng.randn(NUM_DRUGS, D).astype(np.float32)
    w = rng.randn(RANK_CHUNK, D, D).astype(np.float32) / D
    w = (w + w.transpose(0, 2, 1)) / 2
    ranks = R.rank_tensor(z, w, chunk=RANK_CHUNK, device="cuda")
    ens = work / "ensemble"
    ens.mkdir(parents=True, exist_ok=True)
    ckpts, _, _, _ = ensemble_checkpoints(ens)
    cli_predict.main(ensemble_argv(ckpts)
                     + ["--export_ranks", str(ens / "ranks.npy"),
                        "--export_embeddings", str(ens / "z.npy")])
    return ranks, z, w, ens


# ------------------------------------------------------------ training
def hgt_k2(mod, g) -> tuple:
    """K2's launches in one HGTEncoder forward over `g`, and the function
    of the node types whose outputs get a gradient giving those of its
    backward, as the code runs them (`models/hgt.py`, `ops/segment.py`,
    `ops/gather.py`). Forward: per conv, the softmax denominators and the
    message sums, per edge type (per_edge_type scope) or per destination
    type (global). Backward, per conv from the last, for the edge types
    whose destination type reaches the loss: the transposes of the
    destination gather, of the source gather (when the batch has the
    source layout and src_sorted_bwd is on) and, per edge type or per
    destination type, of the denominators' gather; with the remat, the
    recompute's two forward sums."""
    convs = [getattr(mod, f"conv_{i}") for i in range(mod.num_layers)]
    require(bool(g.edge_dst_starts), "an HGT ran on a KG batch without "
            "its destination layouts: its sums would not run on K2")
    fwd = 0
    for conv in convs:
        if conv.softmax_scope == "global":
            require(conv.edge_types == g.metadata.edge_types
                    and bool(g.dst_type_starts),
                    "a global-scope HGT ran without its per-type layouts")
            fwd += 2 * len({et[2] for et in conv.edge_types})
        else:
            fwd += 2 * len(conv.edge_types)
    src = set(g.edge_src_order)

    def bwd(grad_types) -> int:
        need, n = set(grad_types), 0
        for conv in reversed(convs):
            live = [et for et in conv.edge_types if et[2] in need]
            for et in live:
                n += 1 + int(conv.src_sorted_bwd and edge_key(et) in src)
                if conv.softmax_scope != "global":
                    n += 1 + 2 * int(conv.remat_edge_types)
            if conv.softmax_scope == "global":
                n += len({et[2] for et in live})
            need |= {et[0] for et in live}
        return n

    return fwd, bwd


def han_k2(mod, g) -> tuple:
    """As hgt_k2 for an HANEncoder: forward, per conv and edge type, the
    denominators and the message sums; backward, per live edge type, the
    transposes of the destination gather, the denominators' gather and
    (with the source layout) the source gather. A node type feeds the
    conv below it through the edge types it is a source or a destination
    of."""
    convs = [getattr(mod, f"conv_{i}") for i in range(mod.num_layers)]
    require(bool(g.edge_dst_starts), "an HAN ran without its layouts")
    src = set(g.edge_src_order)

    def bwd(grad_types) -> int:
        need, n = set(grad_types), 0
        for conv in reversed(convs):
            live = [et for et in conv.edge_types if et[2] in need]
            n += sum(2 + int(edge_key(et) in src) for et in live)
            need = {t for et in live for t in (et[0], et[2])}
        return n

    return sum(2 * len(c.edge_types) for c in convs), bwd


def rgcn_k2(mod, g) -> tuple:
    """An RGCNEncoder: one sum a (layer, relation); backward, the source
    gathers' transposes (with the source layout) of every layer above
    the first, whose input is the node features."""
    require(bool(g.edge_dst_starts), "an RGCN ran without its layouts")
    rel = len(g.metadata.edge_types)
    n_src = len(g.edge_src_order)
    return mod.num_layers * rel, lambda _: (mod.num_layers - 1) * n_src


def mol_k2(mod, g) -> tuple:
    """A GINEncoder (per layer one message sum, the readout's sum; the
    backward, the source gather's transpose of every layer above the
    first) or a GATEncoder (per layer the denominators and the message
    sums, the readout; the backward, per layer the transposes of the
    source, destination and denominators' gathers)."""
    require(g.edge_dst_starts is not None and g.node_graph_starts
            is not None, "a molecule encoder ran without its layouts")
    L = mod.num_layers
    if isinstance(mod, GATEncoder):
        return 2 * L + 1, lambda _: 3 * L
    return L + 1, lambda _: L - 1


def chemcpa_k2(mod, g, return_basal=False) -> tuple:
    """A ChemCPAEncoder: no sum forward; backward, the transposes of its
    covariate and (with use_drugs) drug embedding gathers, where those
    weights train and the latent is not the basal one."""
    if return_basal:
        return 0, lambda _: 0
    tables = [mod.cov_embedding.weight] + (
        [mod.drug_embeddings.weight] if mod.cfg.use_drugs else [])
    return 0, lambda _: sum(int(t.requires_grad) for t in tables)


K2_FORMULAS = {HGTEncoder: hgt_k2, HANEncoder: han_k2,
               RGCNEncoder: rgcn_k2, GINEncoder: mol_k2, GATEncoder: mol_k2,
               ChemCPAEncoder: chemcpa_k2}


class K2Expect:
    """The K2 launches that the encoder passes between reset_launches()
    and read_launches() need, by the formulas above: a global module
    forward hook takes each KG or molecule encoder's forward count when it
    runs, and hooks on its outputs collect the ones a gradient reaches;
    their backward count is taken at read_launches(). What the hooks
    observe is which encoders ran and where the gradients went; how many
    launches each needs is derived from the code."""

    def __init__(self):
        self.handle, self.records = None, []

    def start(self) -> None:
        self.stop()
        self.records = []
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self._hook, with_kwargs=True)

    def stop(self) -> None:
        if self.handle is not None:
            self.handle.remove()
            self.handle = None

    def _hook(self, mod, args, kwargs, out) -> None:
        formula = K2_FORMULAS.get(type(mod))
        if formula is None:
            return
        if formula is chemcpa_k2:
            fwd, bwd = formula(mod, None, kwargs.get(
                "return_basal", len(args) > 4 and args[4]))
        else:
            fwd, bwd = formula(mod, args[0] if args else kwargs["g"])
        rec = [type(mod).__name__, fwd, bwd, set()]
        self.records.append(rec)
        items = (out.items() if isinstance(out, dict)
                 else enumerate(out) if isinstance(out, (tuple, list))
                 else [(0, out)])
        for key, t in items:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda grad, key=key, rec=rec:
                                rec[3].add(key))

    def launches(self) -> dict:
        """{'forward', 'backward', 'total', 'passes': {encoder: count}}."""
        fwd = sum(r[1] for r in self.records)
        bwd = sum(r[2](r[3]) for r in self.records if r[3])
        passes = {}
        for r in self.records:
            passes[r[0]] = passes.get(r[0], 0) + 1
        return {"forward": fwd, "backward": bwd, "total": fwd + bwd,
                "passes": passes}


K2_EXPECT = K2Expect()


def reset_launches() -> None:
    """Every kernel's launch count to 0, and K2's expected count with it."""
    bilinear.bilinear_scores.launches = 0
    segment_sorted.sorted_segment_sum.launches = 0
    K2_EXPECT.start()


def read_launches() -> dict:
    """The launch counts since reset_launches(); K2's expected count stops
    with them (k2_expected)."""
    K2_EXPECT.stop()
    return {"bilinear_scores": bilinear.bilinear_scores.launches,
            "sorted_segment_sum": segment_sorted.sorted_segment_sum.launches}


def k2_expected() -> dict:
    """K2's launches that the encoder passes between the last
    reset_launches() and read_launches() need (K2Expect.launches)."""
    return K2_EXPECT.launches()


def require_k2(counts: dict, path: str) -> dict:
    """The path's K2 launches equal the count its encoder passes need, and
    are more than 0; returns that count's parts."""
    want = k2_expected()
    require(counts["sorted_segment_sum"] == want["total"] > 0,
            f"{path}: K2 launched {counts['sorted_segment_sum']} times, its "
            f"encoder passes need {want}")
    return want


def k2_live_edge_types(edge_types, num_layers: int) -> list:
    """The edge types whose backward runs in one training step, one list
    per HGT layer from the last: those whose messages reach the drug table
    the model reads. In the last layer only the edge types into drugs
    count, in the layer before also those into their source types."""
    need, out = {"drug"}, []
    for _ in range(num_layers):
        live = [et for et in edge_types if et[2] in need]
        out.append(live)
        need |= {et[0] for et in live}
    return out


def config_overrides(cfg) -> list:
    """`--set KEY=VALUE` for every field of a config (the card has no
    YAML loader)."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out += [a if a == "--set" else f"{f.name}.{a}"
                    for a in config_overrides(v)]
        else:
            out += ["--set", f"{f.name}={json.dumps(C.to_dict(v))}"]
    return out


def phase_train_small():
    """Training steps on a small dataset, dropout 0, on the card against
    the CPU from the same weights and masks (every loss within 1e-4
    relative: the same f32 math summed in another order, moved through
    the optimizer's steps): 3 steps under AdamW at flagship widths, and
    OPTIM_STEPS under RAdam and LARS at narrow widths (narrow_config),
    RAdam's last two past its rectification threshold; and the card's
    step-1 HGT gradients through K2 against those through the plain
    backward (within 1e-4 of each tensor's largest: K2 and index_add_ sum
    the same rows in another order)."""
    ds, splits = make_split_dataset(seed=3)
    cfg = flagship_config(ds.num_labels, dropout=False)
    model = random_model(cfg, ds, seed=1)
    narrow = narrow_config(ds.num_labels)
    narrow_model = random_model(narrow, ds, seed=1)
    runs = {"cpu": ("cpu", True, 3, cfg, model),
            "cuda": ("cuda", True, 3, cfg, model),
            "cuda_plain_bwd": ("cuda", False, 1, cfg, model)}
    for opt in ("radam", "lars"):
        opt_cfg = dataclasses.replace(narrow, optim=dataclasses.replace(
            narrow.optim, optimizer=opt))
        for dev in ("cpu", "cuda"):
            runs[f"{dev}_{opt}"] = (dev, True, OPTIM_STEPS, opt_cfg,
                                    narrow_model)
    losses, grads, launches, evals, seconds, k2_want = {}, {}, {}, {}, {}, {}
    for name, (dev, src_sort, steps, run_cfg, start) in runs.items():
        t0 = time.perf_counter()
        batch, kg = DDICollator(ds, split="train", seed=0, device=dev,
                                kg_src_sort=src_sort)()
        trainer = FinetuneTrainer(run_cfg, batch, kg,
                                  copy.deepcopy(start).to(dev))
        reset_launches()
        losses[name] = []
        for step in range(steps):
            losses[name].append(trainer.train_epoch())
            if step == 0:
                grads[name] = {k: p.grad.detach().cpu()
                               for k, p in trainer.model.named_parameters()
                               if "kg_encoder" in k}
        launches[name] = read_launches()
        if dev == "cuda":
            k2_want[name] = require_k2(launches[name],
                                       f"train_small ({name})")
        if name in ("cpu", "cuda"):  # the Evaluator's val sweep after 3
            val = DDICollator(ds, split="val", seed=0, device=dev)(
                splits["val"], build_kg=False)[0]
            ev = Evaluator(trainer.model, cfg.finetune_mode)
            evals[name] = (ev.evaluate_ft(val, kg, "val"), ev.best_metrics)
        seconds[name] = time.perf_counter() - t0
    n_types = len(ds.kg_edge_indices)
    # the plain source gathers' backward takes no K2: one launch less a
    # step for each (layer, edge type) reaching the drugs
    plain = (launches["cuda"]["sorted_segment_sum"] // runs["cuda"][2]
             - launches["cuda_plain_bwd"]["sorted_segment_sum"])
    require(plain == sum(map(len, k2_live_edge_types(
        list(ds.kg_edge_indices), cfg.model.encoder.hgt.num_layers))),
            f"train_small: the plain backward ran {plain} fewer K2 launches")
    loss_err = {}
    for opt, (cpu, card) in {"adamw": ("cpu", "cuda"),
                             "radam": ("cpu_radam", "cuda_radam"),
                             "lars": ("cpu_lars", "cuda_lars")}.items():
        loss_err[opt] = 0.0
        for lc, lg in zip(losses[cpu], losses[card]):
            for k in lc:
                rel = abs(lg[k] - lc[k]) / abs(lc[k])
                require(np.isfinite(lg[k]) and rel <= 1e-4,
                        f"train_small ({opt}): loss {k} on the card "
                        f"{lg[k]} against {lc[k]} on the CPU")
                loss_err[opt] = max(loss_err[opt], rel)
    grad_err = 0.0
    for k, g in grads["cuda"].items():
        ref = grads["cuda_plain_bwd"][k]
        err = (g - ref).abs().max().item()
        require(err <= 1e-4 * ref.abs().max().item(),
                f"train_small: HGT gradient {k} through K2 differs from "
                f"the plain backward by {err}")
        grad_err = max(grad_err, err / max(ref.abs().max().item(), 1e-30))
    # the val metrics of the card's model against the CPU's, within 1e-4
    (key_g, best_g), (key_c, best_c) = evals["cuda"], evals["cpu"]
    require(np.isfinite(key_c) and sorted(best_g) == sorted(best_c),
            f"train_small: val key {key_c} or metric names differ")
    metric_err = abs(key_g - key_c)
    for k, want in best_c.items():
        got = best_g[k]
        require((np.isnan(got) and np.isnan(want))
                or abs(got - want) <= 1e-4,
                f"train_small: val metric {k} on the card {got} against "
                f"{want} on the CPU")
        if not np.isnan(want):
            metric_err = max(metric_err, abs(got - want))
    emit({"phase": "train_small", "drugs": ds.num_drugs,
          "outcomes": ds.num_labels, "kg_edge_types": n_types,
          "optim_steps": OPTIM_STEPS,
          "optim_widths": {"feature_dim": narrow.model.encoder.feature_dim,
                           "hgt": narrow.model.encoder.hgt.hidden_dim},
          "losses_cuda": {n: losses[n] for n in runs if n.startswith("cuda")},
          "losses_cpu": {n: losses[n] for n in runs if n.startswith("cpu")},
          "max_rel_loss_err_vs_cpu": loss_err,
          "max_rel_hgt_grad_err_k2_vs_plain": grad_err,
          "val_key_cuda": key_g, "val_key_cpu": key_c,
          "max_abs_val_metric_err_vs_cpu": metric_err,
          "launches": launches, "k2_expected": k2_want, "run_s": seconds})


def train_argv(memory_flags, epochs: int, save_dir: Path,
               seed: int = 0, evaluate_interval: int = 0,
               shrink: int = TRAIN_SHRINK, cfg=None) -> list:
    """The training CLI's arguments at the flagship configuration (or
    `cfg`) on the reference scale divided by `shrink`; with an
    evaluate_interval, also the test pass."""
    return config_overrides(cfg or flagship_config(NUM_LABELS)) + [
        *memory_flags, "--platform", "cuda", "--synthetic_scale",
        "--synthetic_scale_shrink", str(shrink),
        "--finetune_mode", "str_random_sample", "--label_chunk", "64",
        "--num_epochs", str(epochs),
        "--evaluate_interval", str(evaluate_interval),
        *(["--test"] if evaluate_interval else []),
        "--seed", str(seed), "--save_dir", str(save_dir)]


def phase_training():
    """The training CLI at the flagship configuration on the reference
    scale divided by SYNTHETIC_TRAIN_SHRINK, with TRAIN_MEMORY_FLAGS, one
    evaluation sweep on the val split and the test pass."""
    save_dir = WORK / "train"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    argv = train_argv(TRAIN_MEMORY_FLAGS, TRAIN_EPOCHS, save_dir,
                      evaluate_interval=TRAIN_EVAL_INTERVAL,
                      shrink=SYNTHETIC_TRAIN_SHRINK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        rec.wrap(cli_common, "make_reference_scale_dataset", keep=True)
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        res = cli_train_ddi.main(argv)
        t_cli = time.perf_counter() - t0
        counts = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_k2_shapes(rec.results["make_reference_scale_dataset"][0]
                    .kg_edge_indices, SYNTHETIC_TRAIN_SHRINK, "training")

    k2_want = require_k2(counts, "training")
    require(len(res["losses"]) == TRAIN_EPOCHS
            and all(np.isfinite(v) for l in res["losses"]
                    for v in l.values()),
            f"training losses: {res['losses']}")
    model, cfg = P.model_from_checkpoint(res["checkpoint"], device="cuda")
    require(cfg.num_epochs == TRAIN_EPOCHS and all(
        torch.isfinite(t).all() for t in model.state_dict().values()),
            "the last_model checkpoint does not load as trained")
    require(len(res["eval_keys"]) == 1 and np.isfinite(res["eval_keys"][0])
            and res["best_epoch"] == TRAIN_EVAL_INTERVAL
            and (save_dir / "best_model").exists()
            and np.isfinite(res["test_keys"].get("test", np.nan)),
            f"evaluation: keys {res['eval_keys']}, best epoch "
            f"{res['best_epoch']}, test {res['test_keys']}")
    best, _ = P.model_from_checkpoint(str(save_dir / "best_model"),
                                      device="cuda")
    require(all(torch.isfinite(t).all() for t in best.state_dict().values()),
            "the best_model checkpoint does not load")
    emit({"phase": "training", "shrink": SYNTHETIC_TRAIN_SHRINK,
          "memory_flags": TRAIN_MEMORY_FLAGS,
          "drugs": reference_scale_kwargs(
              SYNTHETIC_TRAIN_SHRINK)["num_drugs"],
          "outcomes": model.decoder.weight.shape[0],
          "epochs": TRAIN_EPOCHS, "launches": counts,
          "k2_expected": k2_want,
          "losses": res["losses"], "epoch_s": res["epoch_seconds"],
          "evaluate_interval": TRAIN_EVAL_INTERVAL,
          "eval_s": res["eval_seconds"], "val_key_auprc": res["eval_keys"],
          "test_s": res["test_seconds"], "test_key_auprc": res["test_keys"],
          "data_build_s": res["data_seconds"], "cli_s": t_cli,
          "peak_device_mem_gb": peak})
    shutil.rmtree(save_dir)
    return counts


# ------------------------------------------------------------- stage 1
def stage1_small_runs(ds) -> dict:
    """stage1_small's trainers at narrow_config's encoder widths (dropout
    0): name -> (a function of the device building the trainer from seed 1,
    the function of (trainer, device) taking one step). The host inputs are
    drawn once, so both devices see the same ones."""
    enc = narrow_config(NUM_LABELS).model.encoder
    rng = np.random.RandomState(0)
    labels = (rng.rand(ds.num_drugs, 17) < 0.3).astype(np.float32)
    mask = (rng.rand(ds.num_drugs, 17) < 0.9).astype(np.float32)
    num_nodes = {nt: v.shape[0] for nt, v in ds.kg_node_feats.items()}
    queries, qlabels, message_edges = (
        stage1_lib.HGTLinkPredTrainer.make_link_split(
            ds.kg_edge_indices, rng, num_nodes))
    schema = kg_schema(ds.kg_node_feats, message_edges)
    cpa = dataclasses.replace(enc.chemcpa, use_drugs=True,
                              num_drugs=ds.num_drugs, disable_adv=False)
    genes = ds.tx_table.reshape(-1, ds.tx_table.shape[-1])[:256]
    cov = rng.randint(0, cpa.num_covariates, len(genes))
    drugs = rng.randint(0, ds.num_drugs, len(genes))
    doses = rng.rand(len(genes)).astype(np.float32)
    kgs = {}

    def kg_of(dev, src_sort):
        if (dev, src_sort) not in kgs:
            kgs[dev, src_sort] = build_kg_batch(
                ds.kg_node_feats, message_edges, ds.kg_drug_ids, device=dev,
                src_sort=src_sort)
        return kgs[dev, src_sort]

    def hgt_run(src_sort):
        return (lambda dev: stage1_lib.HGTLinkPredTrainer(
                    enc.hgt, enc.feature_dim, *schema, seed=1, device=dev),
                lambda t, dev: t.train_step(kg_of(dev, src_sort), queries,
                                            qlabels))

    return {
        "str": (lambda dev: stage1_lib.GINPretrainer(
                    enc.gin, enc.feature_dim, 17, seed=1, device=dev),
                lambda t, dev: t.train_step(
                    pack_molecules(ds.molecules, device=dev), labels, mask)),
        "kg": hgt_run(True),
        "kg_plain_bwd": hgt_run(False),
        "cv": (lambda dev: stage1_lib.TabularAETrainer(
                   ds.cv_table.shape[1], enc.cv.hidden_dims, enc.feature_dim,
                   seed=1, device=dev, dropout=0.0),
               lambda t, dev: t.train_step(ds.cv_table)),
        "tx": (lambda dev: stage1_lib.ChemCPAAdaptTrainer(
                   cpa, seed=1, device=dev),
               lambda t, dev: t.train_step(genes, cov, drugs, doses)),
    }


def loss_list(losses) -> list:
    return [v for x in losses for v in (x.values() if isinstance(x, dict)
                                        else [x])]


def phase_stage1_small():
    """The four stage-1 trainers on a small dataset at narrow widths,
    dropout 0, on the card against the CPU from the same weights (seed 1)
    and host inputs, STAGE1_SMALL_STEPS steps each (every loss within 1e-4
    relative, as train_small): GIN property prediction, HGT link
    prediction (source-sorted layout: K2 on the card), the tabular
    autoencoder, and chemCPA adaptation with the adversaries (iteration 0
    the adversary step with its double backward, then alternating) and
    use_drugs with the frozen drug table (unchanged on both devices); and
    the card's step-1 HGT gradients through K2 against those through the
    plain backward (within 1e-4 of each tensor's largest)."""
    ds = make_dataset(seed=3)
    runs = stage1_small_runs(ds)
    losses, grads, launches, seconds, frozen = {}, {}, {}, {}, {}
    k2_want = {}
    for name, (build, step) in runs.items():
        for dev in ("cpu", "cuda"):
            if name == "kg_plain_bwd" and dev == "cpu":
                continue
            t0 = time.perf_counter()
            trainer = build(dev)
            before = {k: v.detach().cpu().clone()
                      for k, v in trainer.model.state_dict().items()}
            key = f"{dev}_{name}"
            reset_launches()
            losses[key] = [step(trainer, dev)]
            grads[key] = {k: p.grad.detach().cpu() for k, p in
                          trainer.model.named_parameters()
                          if p.grad is not None}
            if name != "kg_plain_bwd":
                losses[key] += [step(trainer, dev)
                                for _ in range(STAGE1_SMALL_STEPS - 1)]
            launches[key] = read_launches()
            if dev == "cuda" and name in ("str", "kg", "kg_plain_bwd", "tx"):
                k2_want[key] = require_k2(launches[key],
                                          f"stage1_small ({name})")
            seconds[key] = time.perf_counter() - t0
            if name == "tx":
                k = "drug_embeddings.weight"
                frozen[key] = torch.equal(
                    trainer.model.state_dict()[k].cpu(), before[k])
    enc = narrow_config(NUM_LABELS).model.encoder
    require(all(c["bilinear_scores"] == 0 for k, c in launches.items())
            and all(launches[f"{d}_cv"]["sorted_segment_sum"] == 0
                    for d in ("cpu", "cuda")),
            f"stage1_small: launches {launches}")
    require(all(frozen.values()), f"stage1_small: the frozen drug table "
            f"moved ({frozen})")
    loss_err = {}
    for name in ("str", "kg", "cv", "tx"):
        cpu, card = (loss_list(losses[f"{d}_{name}"]) for d in ("cpu",
                                                                "cuda"))
        rel = [abs(g - c) / abs(c) for c, g in zip(cpu, card)]
        require(len(card) == STAGE1_SMALL_STEPS and np.isfinite(card).all()
                and max(rel) <= 1e-4,
                f"stage1_small ({name}): losses on the card {card} against "
                f"{cpu} on the CPU")
        loss_err[name] = max(rel)
    kinds = [next(iter(x)) for x in losses["cuda_tx"]]
    require(kinds == ["loss_adv", "loss_reconstruction"]
            * (STAGE1_SMALL_STEPS // 2),
            f"stage1_small: chemCPA's steps ran as {kinds}")
    grad_err = 0.0
    for k, g in grads["cuda_kg"].items():
        ref = grads["cuda_kg_plain_bwd"][k]
        err = (g - ref).abs().max().item()
        require(err <= 1e-4 * ref.abs().max().item(),
                f"stage1_small: HGT gradient {k} through K2 differs from "
                f"the plain backward by {err}")
        grad_err = max(grad_err, err / max(ref.abs().max().item(), 1e-30))
    emit({"phase": "stage1_small", "drugs": ds.num_drugs,
          "steps": STAGE1_SMALL_STEPS,
          "widths": {"feature_dim": enc.feature_dim,
                     "hgt": enc.hgt.hidden_dim},
          "losses": losses, "max_rel_loss_err_vs_cpu": loss_err,
          "max_rel_hgt_grad_err_k2_vs_plain": grad_err,
          "launches": launches, "k2_expected": k2_want,
          "run_s": seconds})


def stage1_argv(modality: str, save_dir: Path, shrink: int, epochs: int,
                extra=()) -> list:
    """The stage-1 CLI at its defaults, the flagship encoder's widths
    (checked in phase_stage1), on the reference scale divided by
    `shrink`, seed 0: the data the `pretrain` phase trains on."""
    return ["--platform", "cuda", "--synthetic_scale",
            "--synthetic_scale_shrink", str(shrink), "--seed", "0",
            "--modality", modality, "--num_epochs", str(epochs),
            "--save_dir", str(save_dir), *extra]


def check_stage1_defaults() -> None:
    """The stage-1 CLI's default widths are the flagship encoder's."""
    a = cli_stage1.build_parser().parse_args(["--modality", "kg"])
    enc = flagship_config(NUM_LABELS).model.encoder
    got = (a.feature_dim, tuple(a.gin_hidden_dims), a.gin_num_mlp_layer,
           a.hgt_hidden_dim, a.hgt_num_layers, a.hgt_att_heads,
           tuple(a.cv_hidden_dims), a.tx_width, a.tx_depth)
    want = (enc.feature_dim, tuple(enc.gin.hidden_dims),
            enc.gin.num_mlp_layer, enc.hgt.hidden_dim, enc.hgt.num_layers,
            enc.hgt.att_heads, tuple(enc.cv.hidden_dims),
            enc.chemcpa.autoencoder_width, enc.chemcpa.autoencoder_depth)
    require(got == want and not enc.chemcpa.use_drugs,
            f"stage 1's default widths {got} are not the flagship's {want}")


def check_stage1_keys(sd: dict, encoder_sd: dict, modality: str) -> dict:
    """A stage-1 checkpoint holds every entry of the encoder subtree it
    overlays, at its shape; its other entries are only what stage 1 alone
    trains (kg: the other node types' heads; tx: the chemCPA decoder).
    Returns the counts."""
    prefix = f"{modality}_encoder."
    target = {k: v.shape for k, v in encoder_sd.items()
              if k.startswith(prefix)}
    extra = sorted(set(sd) - set(target))
    require(target and all(k in sd and sd[k].shape == s
                           for k, s in target.items())
            and all(k.startswith(prefix) for k in sd)
            and all(k.startswith(("kg_encoder.lin__",
                                  "tx_encoder.decoder."))
                    and "lin__drug" not in k for k in extra),
            f"stage 1 ({modality}): checkpoint keys do not fit the encoder "
            f"(extra {extra[:5]})")
    return {"overlaid": len(target), "stage1_only": len(extra)}


def read_metrics(save_dir: Path, modality: str) -> list:
    with open(save_dir / f"pretrain_{modality}_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def phase_stage1() -> dict:
    """Stage 1 through `cli.modality_pretrain` at the flagship encoder's
    widths: kg at the full reference scale for STAGE1_KG_EPOCHS
    full-graph steps (the link split's and the KG build's seconds, each
    step's, the peak device memory; K2 at the message edges' shapes that
    phase_k2_kernels checked, launched once a (layer, edge type) a step),
    then str, cv and tx at the reference scale / STAGE1_SHRINK for
    STAGE1_EPOCHS steps (tx at the reference's batch, with the
    disentanglement probe); each run's counts set to 0 just before it and
    read just after; each checkpoint's keys against the encoder subtree it
    overlays. Returns (the counts summed over the four runs, {modality:
    checkpoint path})."""
    check_stage1_defaults()
    save_dir = WORK / "stage1"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    paths, counts, lines = {}, {}, {}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        rec.wrap(cli_common, "make_reference_scale_dataset", keep=True)
        rec.wrap(stage1_lib.HGTLinkPredTrainer, "make_link_split", keep=True)
        rec.wrap(kg_lib, "build_kg_batch")
        rec.wrap(stage1_lib.HGTLinkPredTrainer, "train_step", sync=True)
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        paths["kg"] = cli_stage1.main(stage1_argv(
            "kg", save_dir, TRAIN_SHRINK, STAGE1_KG_EPOCHS))
        t_cli = time.perf_counter() - t0
        counts["kg"] = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9
    ds = rec.results["make_reference_scale_dataset"][0]
    queries, labels, message_edges = rec.results["make_link_split"][0]
    check_k2_shapes(message_edges, TRAIN_SHRINK, "stage1", link_split=True)
    require(counts["kg"]["bilinear_scores"] == 0,
            f"stage1 (kg): launches {counts['kg']}")
    k2_kg = require_k2(counts["kg"], "stage1 (kg)")
    step_s = rec.seconds["train_step"]
    losses = [r["kg_loss"] for r in read_metrics(save_dir, "kg")]
    require(len(losses) == STAGE1_KG_EPOCHS and np.isfinite(losses).all(),
            f"stage1 (kg): losses {losses}")
    lines["kg"] = {
        "shrink": TRAIN_SHRINK, "epochs": STAGE1_KG_EPOCHS,
        "drugs": ds.num_drugs,
        "kg_edges": int(sum(e.shape[1] for e in ds.kg_edge_indices.values())),
        "message_edges": int(sum(e.shape[1]
                                 for e in message_edges.values())),
        "queries": len(labels), "positives": int(labels.sum()),
        "k2_expected": k2_kg,
        "losses": losses, "first_step_s": step_s[0],
        "steady_step_s": float(np.median(step_s[1:])), "step_s": step_s,
        "data_build_s": rec.seconds["make_reference_scale_dataset"][0],
        "link_split_s": rec.seconds["make_link_split"][0],
        "kg_build_s": rec.seconds["build_kg_batch"][0], "cli_s": t_cli,
        "peak_device_mem_gb": peak}
    schema = kg_schema(ds.kg_node_feats, ds.kg_edge_indices)
    del ds, queries, labels, message_edges, rec

    for mod, extra in (("str", ()), ("cv", ()),
                       ("tx", ("--tx_batch_size", str(STAGE1_TX_BATCH),
                               "--eval_disentanglement"))):
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        paths[mod] = cli_stage1.main(stage1_argv(
            mod, save_dir, STAGE1_SHRINK, STAGE1_EPOCHS, extra))
        t_cli = time.perf_counter() - t0
        counts[mod] = read_launches()  # counts end here
        records = read_metrics(save_dir, mod)
        losses = loss_list([{k: v for k, v in r.items()
                             if k.endswith("loss") or k.startswith("loss")}
                            for r in records])
        # the str run's GIN sums on K2, and the tx run's embedding
        # gathers' transposes; cv reduces no segments
        k2_mod = (require_k2(counts[mod], f"stage1 ({mod})")
                  if mod != "cv" else None)
        require(counts[mod]["bilinear_scores"] == 0
                and (mod != "cv" or counts[mod]["sorted_segment_sum"] == 0)
                and len(losses) == STAGE1_EPOCHS
                and np.isfinite(losses).all(),
                f"stage1 ({mod}): launches {counts[mod]}, losses {losses}")
        lines[mod] = {"shrink": STAGE1_SHRINK, "epochs": STAGE1_EPOCHS,
                      "losses": losses, "cli_s": t_cli,
                      "k2_expected": k2_mod}
        if mod == "tx":
            final = {k: v for r in records for k, v in r.items()
                     if k == "tx_r2" or k.startswith("tx_disent_")}
            require(np.isfinite(final.get("tx_r2", np.nan))
                    and "tx_disent_covariate" in final,
                    f"stage1 (tx): evaluations {final}")
            lines[mod].update(batch=STAGE1_TX_BATCH, **final)

    encoder_sd = MadrigalEncoder(flagship_config(NUM_LABELS).model.encoder,
                                 *schema).state_dict()
    for mod, path in paths.items():
        lines[mod]["keys"] = check_stage1_keys(load_checkpoint(path)[0],
                                               encoder_sd, mod)
    emit({"phase": "stage1", "launches": counts, **lines})
    total = {k: sum(c[k] for c in counts.values()) for k in counts["kg"]}
    return total, paths


# ------------------------------------------------------------- stage 2
def pretrain_small_config(optimizer: str) -> C.PretrainConfig:
    """pretrain_small's stage-2 configuration: narrow_config's encoder
    (dropout 0), batch 16 of the small dataset's drugs. AdamW trains the
    raw-encoder-output views (the full run's); LARS, with a rate high and
    a warmup short enough that its trust-scaled updates are not zero,
    trains through the fusion transformer."""
    enc = narrow_config(NUM_LABELS).model.encoder
    kw = (dict(pretrain_lr=0.5, warmup_epochs=1, raw_encoder_output=False)
          if optimizer == "lars" else
          dict(pretrain_lr=1e-3, warmup_epochs=2, raw_encoder_output=True))
    return C.PretrainConfig(
        encoder=enc, pretrain_mode="str_center_uni",
        pretrain_unbalanced=True, pretrain_batch_size=16,
        pretrain_num_epochs=50, pretrain_optimizer=optimizer, seed=0, **kw)


def phase_pretrain_small():
    """Stage-2 steps on a small dataset, dropout 0, on the card against the
    CPU from the same weights (seed 1) and the same host draws: the
    device-table path under AdamW and under LARS, and the host-collate
    path under AdamW, PRETRAIN_SMALL_STEPS steps each (every loss within
    1e-4 relative, as train_small). The card takes step 1 alone and the
    rest through train_steps (the pinned, side-stream prefetch); the CPU
    takes every step alone. And the card's step-1 HGT gradients through
    K2 against those through the plain backward (within 1e-4 of each
    tensor's largest)."""
    ds = make_dataset(seed=3)
    schema = kg_schema(ds.kg_node_feats, ds.kg_edge_indices)
    runs = {f"{dev}_{name}": (dev, table, opt, True)
            for name, table, opt in (("adamw", True, "adamw"),
                                     ("lars", True, "lars"),
                                     ("adamw_host", False, "adamw"))
            for dev in ("cpu", "cuda")}
    runs["cuda_plain_bwd"] = ("cuda", True, "adamw", False)
    losses, grads, launches, seconds, k2_want = {}, {}, {}, {}, {}
    for name, (dev, table, opt, src_sort) in runs.items():
        t0 = time.perf_counter()
        cfg = pretrain_small_config(opt)
        model = init_weights(build_simclr_model(cfg, *schema),
                             torch.Generator().manual_seed(1))
        coll = DDICollator(ds, split="train", seed=0, device=dev,
                           kg_src_sort=src_sort)
        trainer = CLPretrainer(cfg, coll, coll.kg_batch(), model.to(dev),
                               device_table=table)
        reset_launches()
        losses[name] = [trainer.train_step()]
        grads[name] = {k: p.grad.detach().cpu()
                       for k, p in trainer.model.named_parameters()
                       if "kg_encoder" in k}
        if name != "cuda_plain_bwd":
            rest = PRETRAIN_SMALL_STEPS - 1
            losses[name] += (trainer.train_steps(rest) if dev == "cuda"
                             else [trainer.train_step() for _ in range(rest)])
        launches[name] = read_launches()
        if dev == "cuda":
            k2_want[name] = require_k2(launches[name],
                                       f"pretrain_small ({name})")
        seconds[name] = time.perf_counter() - t0
    enc = pretrain_small_config("adamw").encoder
    require(all(c["bilinear_scores"] == 0 for c in launches.values()),
            f"pretrain_small: launches {launches}")
    loss_err = {}
    for name in ("adamw", "lars", "adamw_host"):
        cpu, card = losses[f"cpu_{name}"], losses[f"cuda_{name}"]
        rel = [abs(g - c) / abs(c) for c, g in zip(cpu, card)]
        require(len(card) == PRETRAIN_SMALL_STEPS and np.isfinite(card).all()
                and max(rel) <= 1e-4,
                f"pretrain_small ({name}): losses on the card {card} "
                f"against {cpu} on the CPU")
        loss_err[name] = max(rel)
    grad_err = 0.0
    for k, g in grads["cuda_adamw"].items():
        ref = grads["cuda_plain_bwd"][k]
        err = (g - ref).abs().max().item()
        require(err <= 1e-4 * ref.abs().max().item(),
                f"pretrain_small: HGT gradient {k} through K2 differs from "
                f"the plain backward by {err}")
        grad_err = max(grad_err, err / max(ref.abs().max().item(), 1e-30))
    emit({"phase": "pretrain_small", "drugs": ds.num_drugs,
          "steps": PRETRAIN_SMALL_STEPS,
          "widths": {"feature_dim": enc.feature_dim,
                     "hgt": enc.hgt.hidden_dim},
          "losses": losses, "max_rel_loss_err_vs_cpu": loss_err,
          "max_rel_hgt_grad_err_k2_vs_plain": grad_err,
          "launches": launches, "k2_expected": k2_want, "run_s": seconds})


def pretrain_argv(save_dir: Path, steps: int, shrink: int = TRAIN_SHRINK,
                  extra=()) -> list:
    """The stage-2 CLI at the flagship encoder (float32; the JAX
    package's bf16 compute types are not ported) with the JAX package's
    stage-2 settings (scripts/cli_wall_bench.py FLAGSHIP_SETS_CL: fusion
    chunk 512 and remat, the HGT remat as PRETRAIN_HGT_REMAT;
    str_center_uni, unbalanced, raw encoder output, batch
    PRETRAIN_BATCH) on the reference scale divided by `shrink`, seed 0:
    the data the `data_dir` phase writes."""
    enc = flagship_config(NUM_LABELS).model.encoder
    enc = dataclasses.replace(
        enc, fusion_batch_chunk=512,
        transformer=dataclasses.replace(enc.transformer, remat=True),
        hgt=dataclasses.replace(enc.hgt,
                                remat_edge_types=PRETRAIN_HGT_REMAT))
    return [a if a == "--set" else "encoder." + a
            for a in config_overrides(enc)] + [
        "--platform", "cuda", "--synthetic_scale",
        "--synthetic_scale_shrink", str(shrink),
        "--pretrain_mode", "str_center_uni", "--pretrain_unbalanced",
        "--raw_encoder_output", "--batch_size", str(PRETRAIN_BATCH),
        "--num_steps", str(steps), "--seed", "0",
        "--save_dir", str(save_dir), *extra]


def run_pretrain(argv, shrink: int, path: str):
    """The stage-2 CLI with the launch counts set to 0 just before it and
    read just after, each step timed to the end of its work on the card;
    K2 held to the launches a step needs and to the shapes
    phase_k2_kernels checked. Returns (the CLI's result, counts, step
    seconds, CLI seconds, peak device GB, checkpoint save seconds, the
    dataset the CLI built)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        rec.wrap(cli_common, "make_reference_scale_dataset", keep=True)
        rec.wrap(pretrain_cl.CLPretrainer, "_run_step", sync=True)
        rec.wrap(ckpt_lib, "save_checkpoint")
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        res = cli_pretrain.main(argv)
        t_cli = time.perf_counter() - t0
        counts = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9
    ds = rec.results["make_reference_scale_dataset"][0]
    check_k2_shapes(ds.kg_edge_indices, shrink, path)
    require(counts["bilinear_scores"] == 0, f"{path}: launches {counts}")
    require_k2(counts, path)
    require(all(np.isfinite(res["losses"])),
            f"{path}: losses {res['losses']}")
    return (res, counts, rec.seconds["_run_step"], t_cli, peak,
            rec.seconds["save_checkpoint"], ds)


def check_stage1_overlay(start: dict, stage1_paths: dict) -> dict:
    """The stage-2 encoder as the trainer received it holds every tensor
    of the stage-1 checkpoints that it declares, exactly. Returns the
    count a modality."""
    taken = {}
    for mod, path in stage1_paths.items():
        sd = load_checkpoint(path)[0]
        kept = [k for k in sd if k in start]
        require(kept and all(torch.equal(start[k], sd[k]) for k in kept),
                f"pretrain: the encoder does not hold stage 1's {mod} "
                "tensors")
        taken[mod] = len(kept)
    return taken


def phase_pretrain(stage1_paths: dict = None):
    """Stage 2 at full scale, warm-started from the four stage-1
    checkpoints where given (--modality_ckpts; the --pretrain loop runs
    without): the CLI for PRETRAIN_STEPS steps with a checkpoint every
    PRETRAIN_SAVE_EVERY; the encoder before the first step against the
    stage-1 tensors; the checkpoints' names, steps and contents. Returns
    (counts, the cl_last path, the encoder's state_dict before the first
    step, the dataset): the data_dir phase warm-starts from cl_last, and
    pretrain_embeds compares the encoder before and after."""
    save_dir = WORK / "pretrain"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    starts, orig_init = [], pretrain_cl.CLPretrainer.__init__

    def snapshot(self, cfg, collator, kg, model, **kw):
        starts.append({k: v.detach().cpu().clone()
                       for k, v in model.base_encoder.state_dict().items()})
        orig_init(self, cfg, collator, kg, model, **kw)

    pretrain_cl.CLPretrainer.__init__ = snapshot
    try:
        res, counts, step_s, t_cli, peak, save_s, ds = run_pretrain(
            pretrain_argv(save_dir, PRETRAIN_STEPS, extra=(
                "--save_checkpoints", str(PRETRAIN_SAVE_EVERY),
                *(["--modality_ckpts", *stage1_paths.values()]
                  if stage1_paths else []))),
            TRAIN_SHRINK, "pretrain")
    finally:
        pretrain_cl.CLPretrainer.__init__ = orig_init
    overlay = (check_stage1_overlay(starts[0], stage1_paths)
               if stage1_paths else None)
    boundaries = list(range(PRETRAIN_SAVE_EVERY, PRETRAIN_STEPS,
                            PRETRAIN_SAVE_EVERY))
    require([Path(p).name for p in res["checkpoints"]]
            == [f"cl_checkpoint_{b}" for b in boundaries]
            and len(res["losses"]) == PRETRAIN_STEPS,
            f"pretrain: checkpoints {res['checkpoints']}, "
            f"{len(res['losses'])} steps")
    sd, cfg = load_checkpoint(res["checkpoint"])
    epoch, opt_state, extra = load_train_state(res["checkpoint"])
    require(isinstance(cfg, C.PretrainConfig)
            and cfg.pretrain_batch_size == PRETRAIN_BATCH
            and extra["steps"] == PRETRAIN_STEPS and opt_state
            and all(torch.isfinite(v).all() for v in sd.values())
            and any(k.startswith("predictor_1.") for k in sd),
            "pretrain: cl_last does not hold the trained run")
    emit({"phase": "pretrain", "drugs": NUM_DRUGS,
          "batch": PRETRAIN_BATCH, "steps": PRETRAIN_STEPS,
          "hgt_remat": PRETRAIN_HGT_REMAT, "launches": counts,
          "k2_launches_per_step": counts["sorted_segment_sum"]
          // PRETRAIN_STEPS,
          "losses": res["losses"], "first_step_s": step_s[0],
          "steady_step_s": float(np.median(step_s[1:])), "step_s": step_s,
          "segment_s": res["segment_seconds"],
          "segment_steps": res["segment_steps"],
          "checkpoint_save_s": save_s, "data_build_s": res["data_seconds"],
          "cli_s": t_cli, "peak_device_mem_gb": peak,
          "stage1_tensors_overlaid": overlay})
    return counts, res["checkpoint"], starts[0], ds


def phase_pretrain_final_embeds():
    """Stage 2 at the reference scale / FINAL_EMBEDS_SHRINK with
    --host_collate and --final_embeds_eval for FINAL_EMBEDS_STEPS steps:
    the table written equals the one returned, the embeddings are finite,
    and one pair's alignment recomputed from the saved files equals the
    table's."""
    from madrigal_tpu_torch.eval.cl_metrics import alignment_loss

    save_dir = WORK / "pretrain_final"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    res, counts, step_s, t_cli, peak, _, _ = run_pretrain(
        pretrain_argv(save_dir, FINAL_EMBEDS_STEPS,
                      shrink=FINAL_EMBEDS_SHRINK,
                      extra=("--host_collate", "--final_embeds_eval")),
        FINAL_EMBEDS_SHRINK, "pretrain_final_embeds")
    table = res["final_embeds"]
    with open(save_dir / "final_embeds_metrics.json") as f:
        written = json.load(f)
    require(written == table and "train 0 v 1" in table,
            f"final embeds: table {sorted(table)}")
    files = {p.name: np.load(p) for p in
             (save_dir / "final_embeds").glob("*.npz")}
    require(all(np.isfinite(f["embeds"]).all() for f in files.values()),
            "final embeds: not finite")
    a, b = files["train_embeds_0.npz"], files["train_embeds_1.npz"]
    _, ia, ib = np.intersect1d(a["drugs"], b["drugs"], return_indices=True)
    align = alignment_loss(a["embeds"][ia], b["embeds"][ib])
    require(align == table["train 0 v 1"]["alignment"],
            f"final embeds: alignment {align} against "
            f"{table['train 0 v 1']['alignment']}")
    emit({"phase": "pretrain_final_embeds", "shrink": FINAL_EMBEDS_SHRINK,
          "steps": FINAL_EMBEDS_STEPS, "launches": counts,
          "losses": res["losses"], "step_s": step_s,
          "modality_pairs": len(table), "embedding_files": len(files),
          "final_embeds_s": res["final_embeds_seconds"],
          "data_build_s": res["data_seconds"], "cli_s": t_cli,
          "peak_device_mem_gb": peak})
    shutil.rmtree(save_dir)
    return counts


# ------------------------------------------------- reference-format data
class Recorder:
    """Wraps functions of a module for one run: keeps each call's seconds
    and, where asked, its result, and puts the originals back on exit."""

    def __init__(self):
        self.seconds, self.results, self._undo = {}, {}, []

    def wrap(self, owner, name: str, keep: bool = False,
             sync: bool = False):
        """`sync`: each call's seconds end when the card has finished its
        work. A static method stays one."""
        raw = inspect.getattr_static(owner, name)
        orig = getattr(owner, name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)
            if keep:
                self.results.setdefault(name, []).append(out)
            return out

        setattr(owner, name, staticmethod(wrapped)
                if isinstance(raw, staticmethod) else wrapped)
        self._undo.append((owner, name, raw))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def split_rows(ds, seed: int = 0) -> dict:
    """The 80/10/10 row split of the training CLI's --synthetic_scale path
    (val, test, train), as EdgeTables."""
    df = ds.edge_df
    perm = np.random.RandomState(seed).permutation(len(df))
    n_hold = len(df) // 10
    return {"train": df.take(perm[2 * n_hold:]),
            "val": df.take(perm[:n_hold]),
            "test": df.take(perm[n_hold:2 * n_hold])}


def write_reference_layout(ds, root: Path, split_method: str) -> dict:
    """`ds` on disk in the reference layout through the port's exporter,
    its rows split 80/10/10 into split_method's train/val/test tables;
    returns the split."""
    splits = split_rows(ds)
    ds.edge_df = splits["train"]
    datasets.export_synthetic_as_reference_layout(ds, str(root),
                                                  split_method=split_method)
    for name in ("val", "test"):
        datasets.write_edge_table(splits[name], str(
            root / "polypharmacy_new" / "TWOSIDES" / split_method
            / f"{name}_df.csv"))
    return splits


def check_loaded(got, want) -> None:
    """Every array of the loaded dataset but the molecules equals the
    dataset written, exactly."""
    require((got.num_drugs, got.num_labels) == (want.num_drugs,
                                                want.num_labels),
            f"loaded {got.num_drugs} drugs, {got.num_labels} outcomes")
    for name in ("mod_avail", "cv_table", "tx_table", "tx_dosages",
                 "kg_drug_ids"):
        require(np.array_equal(getattr(got, name), getattr(want, name)),
                f"loaded {name} differs from the dataset written")
    for attr in ("kg_node_feats", "kg_edge_indices"):
        a, b = getattr(got, attr), getattr(want, attr)
        require(list(a) == list(b) and all(np.array_equal(a[k], b[k])
                                           for k in b),
                f"loaded {attr} differs from the dataset written")
    require(got.edge_df.columns == want.edge_df.columns and all(
        np.array_equal(got.edge_df[c], want.edge_df[c])
        for c in want.edge_df.columns),
            "the loaded train table differs from the one written")


def check_warm_start(start: dict, cfg, ds, stage2: dict) -> dict:
    """The model as the trainer received it against the stage-2
    checkpoint (the encoder parameters it keeps, the uni projector too
    under --use_pretrained_adaptor) and against the run's own fresh init
    (the dropped modules, the decoder and every BatchNorm statistic, which
    stage 2 trained away from it), exactly. Returns the counts of each."""
    fresh = init_weights(build_model(
        finetune.training_model_config(cfg),
        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices), device="cpu"),
        torch.Generator().manual_seed(cfg.seed)).state_dict()
    require(set(start) == set(fresh), "the trained model has other entries")
    counts = {"from_checkpoint": 0, "fresh": 0}
    for k, v in start.items():
        top = k.split(".")[1] if k.startswith("encoder.") else None
        taken = (top is not None and top not in CL_TRANSFER_DROP_TOP
                 and not k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked")))
        want = stage2["base_encoder." + k[len("encoder."):]] if taken \
            else fresh[k]
        require(torch.equal(v, want),
                f"warm start: {k} is not the "
                f"{'checkpoint' if taken else 'fresh init'}'s")
        counts["from_checkpoint" if taken else "fresh"] += 1
    return counts


def data_dir_argv(root: Path, save_dir: Path, epochs: int,
                  extra=()) -> list:
    """The training CLI at the flagship configuration on a reference-format
    directory, with TRAIN_MEMORY_FLAGS and DATA_DIR_OPTIMIZER."""
    return config_overrides(flagship_config(NUM_LABELS)) + [
        *TRAIN_MEMORY_FLAGS, "--set", f"optim.optimizer={DATA_DIR_OPTIMIZER}",
        "--platform", "cuda", "--data_dir", str(root),
        "--finetune_mode", "str_random_sample", "--label_chunk", "64",
        "--num_epochs", str(epochs), "--seed", "0",
        "--save_dir", str(save_dir), *extra]


def phase_data_dir(stage2_path: str) -> dict:
    """Reference-format data at full scale: the reference-scale dataset
    written in the reference layout by the port's exporter, then the
    training CLI on it (--data_dir) warm-started from the stage-2
    checkpoint the `pretrain` phase wrote on the same data
    (--checkpoint, --use_pretrained_adaptor) with DATA_DIR_OPTIMIZER for
    DATA_DIR_EPOCHS epochs, one evaluation sweep and the test pass (K2's
    counts set to 0 just before, read just after); the data it loaded
    against the dataset written, the native featurizer against the
    built-in one, the model the trainer received against the checkpoint
    and the fresh init; then the serving CLI on the trained model and the
    same directory. Returns (the training run's counts, the serving
    run's)."""
    work = WORK / "data_dir"
    if work.exists():
        shutil.rmtree(work)
    root, save_dir = work / "reference", work / "train"
    t0 = time.perf_counter()
    ds = make_reference_scale_dataset(seed=0)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    splits = write_reference_layout(ds, root, "split_by_triplets")
    t_export = time.perf_counter() - t0
    tx_bytes = (root / "views_features_new" / "tx" / "tx.csv").stat().st_size
    cfg = flagship_config(NUM_LABELS)
    stage2 = load_checkpoint(stage2_path)[0]

    starts = []
    orig_init = finetune.FinetuneTrainer.__init__

    def snapshot(self, cfg_, batch, kg, model):
        starts.append({k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()})
        orig_init(self, cfg_, batch, kg, model)

    argv = data_dir_argv(root, save_dir, DATA_DIR_EPOCHS, (
        "--checkpoint", stage2_path, "--use_pretrained_adaptor",
        "--evaluate_interval", "1", "--test"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        rec.wrap(datasets, "load_reference_dataset", keep=True)
        rec.wrap(datasets, "read_signature_table")
        rec.wrap(datasets, "load_edge_table")
        finetune.FinetuneTrainer.__init__ = snapshot
        try:
            reset_launches()  # counts start here
            t0 = time.perf_counter()
            res = cli_train_ddi.main(argv)
            t_cli = time.perf_counter() - t0
            counts = read_launches()  # counts end here
        finally:
            finetune.FinetuneTrainer.__init__ = orig_init
    peak = torch.cuda.max_memory_allocated() / 1e9

    loaded = rec.results["load_reference_dataset"][0]
    check_loaded(loaded, ds)
    check_k2_shapes(loaded.kg_edge_indices, TRAIN_SHRINK, "data_dir")
    run_cfg = load_checkpoint(res["checkpoint"])[1]
    warm = check_warm_start(starts[0], run_cfg, ds, stage2)
    require(counts["bilinear_scores"] == 0, f"data_dir: launches {counts}")
    k2_want = require_k2(counts, "data_dir")
    require(len(res["losses"]) == DATA_DIR_EPOCHS
            and all(np.isfinite(v) for l in res["losses"]
                    for v in l.values())
            and len(res["eval_keys"]) == 1
            and np.isfinite(res["eval_keys"][0])
            and np.isfinite(res["test_keys"].get("test", np.nan)),
            f"data_dir: losses {res['losses']}, val {res['eval_keys']}, "
            f"test {res['test_keys']}")

    # the molecules: the native featurizer against the built-in one, which
    # the CLI's loader ran (the card's machine has no RDKit)
    require(not _rdkit_available(),
            "the loader featurized with RDKit, not the built-in parser")
    smiles = datasets._read_metadata(str(root)).strings("canonical_smiles")
    t0 = time.perf_counter()
    mols = featurize_many(smiles, backend="native")
    t_native = time.perf_counter() - t0
    require(len(mols) == len(loaded.molecules) and all(
        m is not None and all(np.array_equal(m[k], w[k]) for k in w)
        for m, w in zip(mols, loaded.molecules)),
            "native featurization differs from the built-in one")

    predict = predict_data_dir(root, save_dir / "best_model", work)
    emit({"phase": "data_dir", "drugs": loaded.num_drugs,
          "outcomes": loaded.num_labels,
          "train_rows": len(loaded.edge_df),
          "eval_rows": {k: len(v) for k, v in splits.items()
                        if k != "train"},
          "kg_edges": int(sum(e.shape[1]
                              for e in loaded.kg_edge_indices.values())),
          "tx_csv_bytes": tx_bytes, "optimizer": DATA_DIR_OPTIMIZER,
          "memory_flags": TRAIN_MEMORY_FLAGS, "launches": counts,
          "k2_expected": k2_want,
          "warm_start": warm, "losses": res["losses"],
          "data_build_s": t_build, "export_s": t_export,
          "load_s": rec.seconds["load_reference_dataset"],
          "signature_tables_s": rec.seconds["read_signature_table"],
          "split_tables_s": rec.seconds["load_edge_table"],
          "featurize_native_s": t_native, "cli_data_s": res["data_seconds"],
          "epoch_s": res["epoch_seconds"], "eval_s": res["eval_seconds"],
          "val_key_auprc": res["eval_keys"], "test_s": res["test_seconds"],
          "test_key_auprc": res["test_keys"], "cli_s": t_cli,
          "peak_device_mem_gb": peak, "predict": predict})
    shutil.rmtree(work)
    return counts, predict["launches"]


def predict_data_dir(root: Path, ckpt: Path, work: Path) -> dict:
    """The serving CLI on the trained model and the reference-format
    directory: its triple answers against the exported embeddings and the
    checkpoint's decoder, within 1e-4 of the largest (K1 is not on this
    path: triples are scored one by one)."""
    emb = str(work / "z.npy")
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    answers = np.asarray(cli_predict.main([
        "--checkpoint", str(ckpt), "--data_dir", str(root),
        "--platform", "cuda", "--label_chunk", str(LABEL_CHUNK),
        "--export_embeddings", emb, "--triples", *TRIPLES]))
    t_cli = time.perf_counter() - t0
    counts = read_launches()  # counts end here
    k2_want = require_k2(counts, "data_dir serving")
    z = np.load(emb).astype(np.float64)
    model, _ = P.model_from_checkpoint(str(ckpt), device="cpu")
    w = P.decoder_weight(model).detach().numpy().astype(np.float64)
    want = np.array([z[a] @ w[l] @ z[b] for l, a, b in
                     (map(int, t.split(":")) for t in TRIPLES)])
    err = float(np.abs(answers - want).max())
    require(z.shape == (NUM_DRUGS, D) and np.isfinite(z).all()
            and err <= 1e-4 * np.abs(want).max(),
            f"data_dir serving: triples {answers} against {want}")
    return {"cli_s": t_cli, "triple_max_abs_err": err, "launches": counts,
            "k2_expected": k2_want}


def phase_all_train() -> dict:
    """The training CLI with --all_train on reference-format data at the
    reference scale / ALL_TRAIN_SHRINK for ALL_TRAIN_EPOCHS epoch: it
    trains on the union of the split_by_pairs train/val/test tables, with
    K2's counts set to 0 just before and read just after."""
    work = WORK / "all_train"
    if work.exists():
        shutil.rmtree(work)
    ds = make_reference_scale_dataset(
        seed=0, **reference_scale_kwargs(ALL_TRAIN_SHRINK))
    rows = len(ds.edge_df)
    write_reference_layout(ds, work / "reference", "split_by_pairs")
    with Recorder() as rec:
        rec.wrap(datasets, "load_reference_all_train", keep=True)
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        res = cli_train_ddi.main(data_dir_argv(
            work / "reference", work / "train", ALL_TRAIN_EPOCHS,
            ("--all_train", "--evaluate_interval", "0")))
        t_cli = time.perf_counter() - t0
        counts = read_launches()  # counts end here
    trained = rec.results["load_reference_all_train"][0]
    check_k2_shapes(trained.kg_edge_indices, ALL_TRAIN_SHRINK, "all_train")
    k2_want = require_k2(counts, "all_train")
    require(len(trained.edge_df) == rows
            and counts["bilinear_scores"] == 0
            and len(res["losses"]) == ALL_TRAIN_EPOCHS
            and all(np.isfinite(v) for l in res["losses"]
                    for v in l.values()),
            f"all_train: {len(trained.edge_df)} rows of {rows}, launches "
            f"{counts}, losses {res['losses']}")
    emit({"phase": "all_train", "shrink": ALL_TRAIN_SHRINK,
          "drugs": trained.num_drugs, "train_rows": len(trained.edge_df),
          "launches": counts, "k2_expected": k2_want,
          "losses": res["losses"],
          "epoch_s": res["epoch_seconds"], "cli_data_s": res["data_seconds"],
          "cli_s": t_cli})
    shutil.rmtree(work)
    return counts


# ------------------------------- alternative encoders, bf16, reference
def alt_config(cfg: C.TrainConfig, str_enc: str, kg_enc: str,
               bf16: bool = False) -> C.TrainConfig:
    """`cfg` with the structure and KG encoders chosen, and with `bf16` both
    compute types (the HGT's edge pipeline, the fusion's matmuls) at
    bfloat16."""
    enc = dataclasses.replace(cfg.model.encoder, str_encoder=str_enc,
                              kg_encoder=kg_enc)
    if bf16:
        enc = dataclasses.replace(
            enc, hgt=dataclasses.replace(enc.hgt, compute_dtype="bfloat16"),
            transformer=dataclasses.replace(enc.transformer,
                                            compute_dtype="bfloat16"))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=enc))


class RowsSeen:
    """Notes the dtype of every row table the gathers' backward hands K2
    (`ops/gather.sorted_segment_sum`), and keeps the rows of the first
    launch of the given (rows, segments, width); the launches themselves
    are counted by the kernel's wrapper as always."""

    def __init__(self, keep: tuple = ()):
        self.dtypes, self.kept, self.keep = [], None, keep

    def __enter__(self):
        self._orig = gather_lib.sorted_segment_sum

        def seen(data, starts, n):
            self.dtypes.append(DTYPE_NAME[data.dtype])
            if (*data.shape, n) == self.keep and self.kept is None:
                self.kept = (data, starts, n)
            return self._orig(data, starts, n)

        gather_lib.sorted_segment_sum = seen
        return self

    def __exit__(self, *exc):
        gather_lib.sorted_segment_sum = self._orig


def phase_alt_small():
    """Each of gat/hgt, gin/han, gin/rgcn, and gat/hgt with both compute
    types at bf16, at narrow_config's widths (dropout 0) on
    ALT_SMALL_DRUGS drugs: ALT_SMALL_STEPS training steps on the card
    against the CPU from the same weights (every float32 loss within 1e-4
    relative, as train_small; every bf16 loss within BF16_LOSS_RTOL
    relative); K2's launches (the HGT's only), and the bf16 run's K2 rows
    in bf16, the others' in f32."""
    ds = make_dataset(num_drugs=ALT_SMALL_DRUGS, seed=3)
    base = narrow_config(ds.num_labels)
    base = dataclasses.replace(base, model=dataclasses.replace(
        base.model, encoder=dataclasses.replace(
            base.model.encoder, gat=C.GATConfig(hidden_dims=(32, 32)),
            han=C.HANConfig(hidden_dim=64, dropout=0.0),
            rgcn=C.RGCNConfig(hidden_dim=64))))
    runs = {f"{s}_{k}": alt_config(base, s, k) for s, k in ALT_ENCODERS}
    runs["gat_hgt_bf16"] = alt_config(base, "gat", "hgt", bf16=True)
    total = {"bilinear_scores": 0, "sorted_segment_sum": 0}
    report = {}
    for name, cfg in runs.items():
        t0 = time.perf_counter()
        start = random_model(cfg, ds, seed=1)
        losses, counts, rows = {}, {}, {}
        for dev in ("cpu", "cuda"):
            batch, kg = DDICollator(ds, split="train", seed=0, device=dev,
                                    kg_src_sort=True)()
            trainer = FinetuneTrainer(cfg, batch, kg,
                                      copy.deepcopy(start).to(dev))
            with RowsSeen() as seen:
                reset_launches()  # counts start here
                losses[dev] = [trainer.train_epoch()
                               for _ in range(ALT_SMALL_STEPS)]
                counts[dev] = read_launches()  # counts end here
            rows[dev] = sorted(set(seen.dtypes))
        bf16 = name.endswith("bf16")
        k2_want = require_k2(counts["cuda"], f"alt_small {name}")
        # the bf16 HGT hands K2 its bf16 gathers' rows, the denominators'
        # f32 ones; every other gather's rows are f32
        require(counts["cuda"]["bilinear_scores"] == 0 and rows["cuda"] == (
            ["bf16", "f32"] if bf16 else ["f32"]),
                f"alt_small {name}: launches {counts['cuda']}, K2 rows "
                f"{rows['cuda']}")
        tol = BF16_LOSS_RTOL if bf16 else 1e-4
        err = 0.0
        for lc, lg in zip(losses["cpu"], losses["cuda"]):
            for k in lc:
                rel = abs(lg[k] - lc[k]) / abs(lc[k])
                require(np.isfinite(lg[k]) and rel <= tol,
                        f"alt_small {name}: loss {k} on the card {lg[k]} "
                        f"against {lc[k]} on the CPU (tolerance {tol})")
                err = max(err, rel)
        total = {k: total[k] + counts["cuda"][k] for k in total}
        report[name] = {"losses_cuda": losses["cuda"],
                        "losses_cpu": losses["cpu"],
                        "max_rel_loss_err_vs_cpu": err, "tol": tol,
                        "launches": counts["cuda"], "k2_rows": rows["cuda"],
                        "k2_expected": k2_want,
                        "run_s": time.perf_counter() - t0}
    emit({"phase": "alt_small", "drugs": ds.num_drugs,
          "steps": ALT_SMALL_STEPS, "widths": {
              "feature_dim": base.model.encoder.feature_dim,
              "gat": list(base.model.encoder.gat.hidden_dims),
              "hgt": base.model.encoder.hgt.hidden_dim,
              "han": 64, "rgcn": 64}, "runs": report})
    return total


def eight_heads_vs_cpu(ckpt: str, ds, scores: np.ndarray) -> dict:
    """The model of `ckpt` on the CPU over `ds`: its ALT_HEADS_VS_CPU first
    drugs' embeddings and their scores against one another, plainly,
    against the card's `scores` [L, heads, N] of the same drugs (within
    1e-4 of max|cpu|: the same f32 math summed in another order)."""
    model, _ = P.model_from_checkpoint(ckpt, device="cpu")
    coll = DDICollator(ds, split="train", seed=0, device="cpu")
    ids = np.arange(ALT_HEADS_VS_CPU)
    with torch.no_grad():
        z = torch.from_numpy(P.embed_all_drugs(model, coll, coll.kg_batch(),
                                               drug_ids=ids))
        ref = bilinear.bilinear_scores_plain(
            z, z, P.decoder_weight(model), torch.float32,
            torch.float32).numpy()
    got = scores[:, :ALT_HEADS_VS_CPU, :ALT_HEADS_VS_CPU]
    err = float(np.abs(got - ref).max())
    require(np.isfinite(got).all()
            and err <= 1e-4 * float(np.abs(ref).max()),
            f"{ckpt}: the card's scores of {ALT_HEADS_VS_CPU} drugs differ "
            f"from the CPU's by {err} (max|cpu| {np.abs(ref).max()})")
    return {"max_abs_err_vs_cpu": err,
            "max_abs_cpu": float(np.abs(ref).max())}


def serve_cut(model, ds) -> tuple:
    """The serving phase's full-scale cut in process: every drug embedded
    (one KG pass) and SERVE_HEADS heads scored against all 6,843 drugs for
    all 960 outcomes through K1, with the launch counts set to 0 just
    before and read just after. Returns (counts, scores, the kg_pass,
    drug_encode and scoring seconds)."""
    coll = DDICollator(ds, split="train", seed=0, device="cuda")
    kg = coll.kg_batch()
    times = PhaseTimes()
    log = logging.getLogger("madrigal_tpu_torch")
    log.addHandler(times)
    log.setLevel(logging.INFO)
    try:
        reset_launches()  # counts start here
        z = P.embed_all_drugs(model, coll, kg)
        scores = P.score_all_pairs(model, z[:SERVE_HEADS], z,
                                   label_chunk=LABEL_CHUNK)
        counts = read_launches()  # counts end here
    finally:
        log.removeHandler(times)
    n_chunks = -(-NUM_LABELS // LABEL_CHUNK)
    require_k2(counts, "serving cut")
    require(counts["bilinear_scores"] == n_chunks
            and scores.shape == (NUM_LABELS, SERVE_HEADS, NUM_DRUGS)
            and np.isfinite(scores).all() and np.isfinite(z).all(),
            f"serving cut: launches {counts}, scores {scores.shape}")
    return counts, scores, {k: times.seconds[k] for k in (
        "kg_pass", "drug_encode", "scoring")}


def phase_alt_encoders(ds):
    """Each of gat/hgt, gin/han and gin/rgcn at full width (the
    reference's GATConfig, HANConfig and RGCNConfig defaults, feature 128,
    the flagship's fusion and decoder): the training CLI at the reference
    scale / ALT_SHRINK for 1 epoch with TRAIN_MEMORY_FLAGS, then the
    serving CLI on its checkpoint exporting the all-pairs scores through
    K1 (ENSEMBLE_CHUNK outcomes a launch), its ALT_HEADS_VS_CPU first
    drugs' scores against the CPU; and the serving phase's full-scale cut
    on `ds` (the serving phase's dataset) with seeded random weights.
    Each run's counts are set to 0 just before it and read just after."""
    work = WORK / "alt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # K1's device time at the serving cut's shape (its launches here are
    # comparison launches, outside every count)
    k1_ms = k1_check(LABEL_CHUNK, SERVE_HEADS, NUM_DRUGS, torch.float32,
                     torch.float32, seed=2, iters=20)["ms"]
    small = reference_scale_kwargs(ALT_SHRINK)
    n_small, l_small = small["num_drugs"], small["num_labels"]
    total = {"bilinear_scores": 0, "sorted_segment_sum": 0}
    report = {}
    for s, k in ALT_ENCODERS:
        name = f"{s}_{k}"
        cfg = alt_config(flagship_config(NUM_LABELS), s, k)
        save_dir, scores_path = work / name, work / f"{name}_scores.npy"
        with Recorder() as rec:
            rec.wrap(cli_common, "make_reference_scale_dataset", keep=True)
            reset_launches()  # counts start here
            t0 = time.perf_counter()
            res = cli_train_ddi.main(train_argv(
                TRAIN_MEMORY_FLAGS, 1, save_dir, shrink=ALT_SHRINK, cfg=cfg))
            t_train = time.perf_counter() - t0
            train_counts = read_launches()  # counts end here
            k2_train = require_k2(train_counts, f"alt_encoders {name} training")
            reset_launches()  # counts start here
            t0 = time.perf_counter()
            cli_predict.main([
                "--checkpoint", res["checkpoint"], "--synthetic_scale",
                "--synthetic_scale_shrink", str(ALT_SHRINK), "--seed", "0",
                "--platform", "cuda", "--label_chunk", str(ENSEMBLE_CHUNK),
                "--export_scores", str(scores_path)])
            t_predict = time.perf_counter() - t0
            predict_counts = read_launches()  # counts end here
            k2_predict = require_k2(predict_counts,
                                    f"alt_encoders {name} serving")
        train_ds, predict_ds = rec.results["make_reference_scale_dataset"]
        want_k1 = -(-l_small // ENSEMBLE_CHUNK)
        require(train_counts["bilinear_scores"] == 0
                and predict_counts["bilinear_scores"] == want_k1
                and len(res["losses"]) == 1
                and all(np.isfinite(v) for v in res["losses"][0].values()),
                f"alt_encoders {name}: training launches {train_counts}, "
                f"serving {predict_counts} (K1 {want_k1}), losses "
                f"{res['losses']}")
        scores = np.load(scores_path, mmap_mode="r")
        require(scores.shape == (l_small, n_small, n_small),
                f"alt_encoders {name}: scores {scores.shape}")
        vs_cpu = eight_heads_vs_cpu(res["checkpoint"], predict_ds,
                                    np.asarray(scores[:, :ALT_HEADS_VS_CPU]))
        require(predict_ds.num_drugs == train_ds.num_drugs == n_small,
                f"alt_encoders {name}: the CLIs built other datasets")
        del scores
        model = random_model(cfg, ds, seed=0).cuda()
        cut_counts, cut, cut_s = serve_cut(model, ds)
        # K1's share of scoring: its launches at their device time
        cut_s["k1_share_of_scoring"] = (cut_counts["bilinear_scores"] * k1_ms
                                        / (cut_s["scoring"] * 1e3))
        del model, cut
        torch.cuda.empty_cache()
        for c in (train_counts, predict_counts, cut_counts):
            total = {key: total[key] + c[key] for key in total}
        report[name] = {
            "train": {"shrink": ALT_SHRINK, "launches": train_counts,
                      "k2_expected": k2_train, "losses": res["losses"],
                      "epoch_s": res["epoch_seconds"], "cli_s": t_train},
            "predict": {"launches": predict_counts, "cli_s": t_predict,
                        "k2_expected": k2_predict, "scores_vs_cpu": vs_cpu},
            "serving_cut": {"launches": cut_counts, **cut_s}}
        shutil.rmtree(save_dir)
        scores_path.unlink()
    emit({"phase": "alt_encoders", "drugs": NUM_DRUGS,
          "outcomes": NUM_LABELS, "head_drugs": SERVE_HEADS,
          "k1_serving_ms": k1_ms, "runs": report})
    shutil.rmtree(work, ignore_errors=True)
    return total


def phase_bf16_train(ds):
    """One full-scale stage-3 step of the flagship with both compute types
    at bf16 and the data_dir phase's memory flags (HGT edge-type remat),
    on the 80% training rows of `ds`: its loss, seconds and peak device
    memory, K2's launches (one a live (layer, edge type), on bf16 rows);
    then K2 on that step's own bf16 rows of the ppi edge type against its
    plain version (k2_check's tolerance), timed beside the plain version,
    `torch.segment_reduce` and the bytes bound. Returns (counts, the K2
    row)."""
    cfg = alt_config(flagship_config(NUM_LABELS), "gin", "hgt", bf16=True)
    enc = cfg.model.encoder
    cfg = dataclasses.replace(cfg, label_chunk_triples=LABEL_CHUNK,
                              model=dataclasses.replace(
                                  cfg.model, encoder=dataclasses.replace(
                                      enc, hgt=dataclasses.replace(
                                          enc.hgt, remat_edge_types=True))))
    ppi = ("protein", "ppi", "protein")
    e_real, e_pad, n_ppi = k2_shapes(TRAIN_SHRINK)[ppi]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch, kg = DDICollator(ds, split="train", seed=0, device="cuda",
                            kg_src_sort=True)(split_rows(ds)["train"])
    trainer = FinetuneTrainer(cfg, batch, kg,
                              random_model(cfg, ds, seed=0).cuda())
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    with RowsSeen(keep=(e_pad, K2_WIDTH, n_ppi)) as seen:
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        losses = trainer.train_epoch()
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        counts = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9
    k2_want = require_k2(counts, "bf16_train")
    # the HGT's gathers hand K2 bf16 rows, its denominators and the GIN's
    # gathers f32 ones
    require(counts["bilinear_scores"] == 0
            and sorted(set(seen.dtypes)) == ["bf16", "f32"]
            and seen.kept is not None
            and all(np.isfinite(v) for v in losses.values()),
            f"bf16_train: launches {counts}, K2 rows {seen.dtypes}, "
            f"losses {losses}")
    data, starts, n = seen.kept
    seen_dtypes = seen.dtypes
    del trainer, batch, kg, seen
    require(n == n_ppi and int(starts[-1]) == e_real,
            f"bf16_train: the kept rows are not ppi's: {n} segments, "
            f"{int(starts[-1])} rows")
    row = {"edge_type": "__".join(ppi), "shrink": TRAIN_SHRINK,
           "path": "bf16_train", **k2_rows_check(data, starts, n, iters=50)}
    emit({"phase": "bf16_train", "drugs": NUM_DRUGS,
          "train_rows": int(len(split_rows(ds)["train"])),
          "compute_dtype": {"hgt": "bfloat16", "transformer": "bfloat16"},
          "memory_flags": TRAIN_MEMORY_FLAGS, "losses": losses,
          "build_s": t_build, "step_s": t_step, "launches": counts,
          "k2_expected": k2_want,
          "k2_rows": {d: seen_dtypes.count(d) for d in ("bf16", "f32")},
          "peak_device_mem_gb": peak,
          "k2_ppi_bf16": row})
    del data, starts
    torch.cuda.empty_cache()
    return counts, row


def reference_state_dict(sd: dict, enc, meta, generator) -> dict:
    """The upstream Madrigal finetune checkpoint (NovelDDIMultilabel's
    state_dict) that holds the port model's weights `sd`, for an encoder of
    the flagship's modules (GIN, PyG 2.3 HGT, MLP cv, chemCPA without
    drugs, x-attn fusion): torchdrug's GIN layout, MLPEncoder's `fc.{i}`
    Sequentials, chemCPA's `network.{i}`, PyG 2.3's HGTConv, torch's packed
    attention projections and the parametrized decoder weight. What the
    reference holds and never reads (the chemCPA decoder, the HGT's output
    heads of the other node types) is drawn from `generator`."""
    from madrigal_tpu_torch.interop.torch_convert import (
        mlp_encoder_linear_positions,
    )

    out = {}
    rnd = lambda *shape: torch.randn(*shape, generator=generator)
    wb, bn = ("weight", "bias"), ("weight", "bias", "running_mean",
                                  "running_var")
    E = "encoder."

    def put(dst, src, names=("",)):
        for p in names:
            out[dst + p] = sd[src + p]

    for i in range(len(enc.gin.hidden_dims) + 1):
        s, d = f"{E}str_encoder.layer_{i}.", f"{E}str_encoder.layers.{i}."
        put(d, s, ("eps", "edge_linear.weight", "edge_linear.bias"))
        for j in range(enc.gin.num_mlp_layer):
            put(f"{d}mlp.layers.{j}.", f"{s}mlp_{j}.", wb)
        put(f"{d}batch_norm.", f"{s}bn.", bn)
    for name, mc in (("cv_encoder", enc.cv), ("uni_projector", enc.proj),
                     ("uni_fuser", enc.proj)):
        lin, norm = mlp_encoder_linear_positions(len(mc.hidden_dims),
                                                 mc.dropout, mc.norm)
        for k, idx in enumerate(lin):
            put(f"{E}{name}.fc.{idx}.", f"{E}{name}.dense_{k}.", wb)
        for k, idx in enumerate(norm):
            put(f"{E}{name}.fc.{idx}.", f"{E}{name}.norm_{k}.",
                bn if mc.norm == "bn" else wb)
    n_lin = enc.chemcpa.autoencoder_depth + 1
    tx = f"{E}tx_encoder."
    for k in range(n_lin):
        put(f"{tx}encoder.network.{3 * k}.", f"{tx}encoder.dense_{k}.", wb)
        w = sd[f"{tx}encoder.dense_{n_lin - 1 - k}.weight"]
        out[f"{tx}decoder.network.{3 * k}.weight"] = rnd(w.shape[1],
                                                         w.shape[0])
        out[f"{tx}decoder.network.{3 * k}.bias"] = rnd(w.shape[1])
        if k < n_lin - 1:
            put(f"{tx}encoder.network.{3 * k + 1}.", f"{tx}encoder.bn_{k}.",
                bn)
            for p in bn:
                out[f"{tx}decoder.network.{3 * k + 1}.{p}"] = (
                    rnd(w.shape[1]).abs() + 0.5)
    out[f"{tx}covariates_embeddings.0.weight"] = sd[
        f"{tx}cov_embedding.weight"]
    hgt, kg = enc.hgt, f"{E}kg_encoder."
    R = len(meta.edge_types)
    for i in range(hgt.num_layers):
        s, d = f"{kg}conv_{i}.", f"{kg}convs.{i}."
        for nt in meta.node_types:
            put(f"{d}kqv_lin.lins.{nt}.", f"{s}kqv__{nt}.", wb)
            for p in wb:
                src = sd.get(f"{s}out__{nt}.{p}")
                out[f"{d}out_lin.lins.{nt}.{p}"] = (
                    src if src is not None else rnd(
                        *(hgt.hidden_dim,) * (2 if p == "weight" else 1)))
            src = sd.get(f"{s}skip__{nt}")
            out[f"{d}skip.{nt}"] = src if src is not None else rnd(1)
        for rel in ("k_rel", "v_rel"):
            per = [sd[f"{s}{rel}__{kg_lib.edge_key(et)}"]
                   for et in meta.edge_types]
            w = torch.empty((hgt.att_heads * R,) + tuple(per[0].shape[1:]))
            for ei, blocks in enumerate(per):
                w[torch.arange(hgt.att_heads) * R + ei] = blocks
            out[f"{d}{rel}.weight"] = w
        for et in meta.edge_types:
            out[f"{d}p_rel.{'__'.join(et)}"] = sd[
                f"{s}p_rel__{kg_lib.edge_key(et)}"].reshape(1, -1)
    for nt in meta.node_types:
        for p in wb:
            src = sd[f"{kg}lin__drug.{p}"]
            out[f"{kg}lin_dict.{nt}.{p}"] = (src if nt == "drug"
                                             else rnd(*src.shape))
    t = f"{E}transformer."
    put(f"{t}embed2latent.", f"{t}embed2latent.", wb)
    put(f"{t}latent2embed.", f"{t}latent2embed.", wb)

    def mha(d, s):
        for p in wb:
            out[f"{d}in_proj_{p}"] = torch.cat(
                [sd[f"{s}{x}_proj.{p}"] for x in "qkv"])
        put(f"{d}out_proj.", f"{s}out_proj.", wb)

    for i in range(enc.transformer.num_layers):
        s = f"{t}transformer_encoder.layer_{i}."
        d = f"{t}transformer_encoder.layers.{i}."
        mha(d + "self_attn.", s + "self_attn.")
        for name in ("linear1", "linear2", "norm1", "norm2"):
            put(f"{d}{name}.", f"{s}{name}.", wb)
    if enc.transformer.agg == "x-attn":
        mha(f"{t}x_attn_mha_layer.", f"{t}x_attn_mha.")
        for name in ("x_attn_kv_norm", "x_attn_query_norm"):
            put(f"{t}{name}.", f"{t}{name}.", wb)
        put(f"{t}x_attn_query", f"{t}x_attn_query")
    for name in ("tx_bottleneck_tokens", "cls", "pos_encoder.pe"):
        if E + name in sd:
            put(E + name, E + name)
    out["decoder.parametrizations.weight.original"] = sd["decoder.weight"]
    return out


def phase_reference_ckpt(ds):
    """A reference-format (upstream Madrigal) finetune state_dict at the
    flagship's widths with the PyG 2.3 HGT (softmax_scope='global'), made
    here from seeded random weights (`reference_state_dict`):
    `state_dict_from_reference` must give back every entry of the model,
    each equal to the weight it came from, and nothing the model lacks;
    the model holding it serves the full-scale cut through K1 (counts set
    to 0 just before, read just after) and its ALT_HEADS_VS_CPU first
    drugs' scores are held to the CPU. Then the same encoder as a
    contrastive (stage-2) state_dict through
    `stage2_checkpoint_from_reference` and the stage-3 warm start: every
    parameter the filter keeps equals the checkpoint's, every other the
    fresh model's, exactly."""
    from madrigal_tpu_torch.interop.from_flax import (
        stage2_checkpoint_from_reference,
        state_dict_from_reference,
    )

    work = WORK / "reference_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = flagship_config(NUM_LABELS)
    enc = dataclasses.replace(cfg.model.encoder, hgt=dataclasses.replace(
        cfg.model.encoder.hgt, softmax_scope="global"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=enc))
    meta = kg_lib.KGMetadata(sorted(ds.kg_node_feats),
                             sorted(ds.kg_edge_indices))
    src = random_model(cfg, ds, seed=5).state_dict()
    t0 = time.perf_counter()
    ref = reference_state_dict(src, enc, meta,
                               torch.Generator().manual_seed(6))
    converted = state_dict_from_reference(ref, enc, meta)
    t_convert = time.perf_counter() - t0
    require(set(converted) == set(src) and all(
        torch.equal(converted[k], src[k]) for k in src),
            "reference_ckpt: the converted state_dict is not the model's: "
            f"{sorted(set(src) ^ set(converted))[:5]}")
    model = random_model(cfg, ds, seed=7)
    missing, unexpected = model.load_state_dict(converted, strict=False)
    require(not missing and not unexpected,
            f"reference_ckpt: missing {missing[:5]}, unexpected "
            f"{unexpected[:5]}")
    ckpt = str(work / "reference_finetune.pt")
    save_checkpoint(ckpt, model, cfg)
    counts, scores, cut_s = serve_cut(model.cuda(), ds)
    del model
    vs_cpu = eight_heads_vs_cpu(ckpt, ds, scores[:, :ALT_HEADS_VS_CPU])
    del scores
    # the contrastive checkpoint's encoder, and the stage-3 warm start
    cl = {"base_encoder." + k[len("encoder."):]: v for k, v in ref.items()
          if k.startswith("encoder.")}
    stage2 = str(work / "reference_cl.pt")
    stage2_checkpoint_from_reference(cl, stage2, C.PretrainConfig(
        encoder=enc), meta, use_pretrained_adaptor=False)
    fresh = random_model(cfg, ds, seed=8)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    kept = ckpt_lib.warm_start_encoder(fresh, load_checkpoint(stage2)[0])
    dropped = CL_TRANSFER_DROP_TOP + ("uni_projector",)
    warm = {"from_checkpoint": 0, "fresh": 0}
    for k, v in fresh.named_parameters():
        top = k.split(".")[1] if k.startswith("encoder.") else None
        taken = top is not None and top not in dropped
        require(torch.equal(v.detach(), src[k] if taken else before[k]),
                f"reference_ckpt warm start: {k} is not the "
                f"{'checkpoint' if taken else 'fresh init'}'s")
        warm["from_checkpoint" if taken else "fresh"] += 1
    require(warm["from_checkpoint"] == len(kept),
            f"reference_ckpt: the warm start took {len(kept)} entries, "
            f"{warm['from_checkpoint']} expected")
    emit({"phase": "reference_ckpt", "hgt_layout": "pyg23",
          "softmax_scope": "global", "reference_entries": len(ref),
          "model_entries": len(src), "convert_s": t_convert,
          "serving_cut": {"launches": counts, **cut_s},
          "scores_vs_cpu": vs_cpu, "warm_start": warm})
    shutil.rmtree(work)
    return counts


# ------------------------ the sweep, the LM head, analysis and profiling
def phase_chemcpa_sweep():
    """The sweep CLI on a JSON file this phase writes: two configs at the
    flagship chemCPA widths (978 genes, 128-d latent, a 512x2
    autoencoder) that differ in the autoencoder's rate, on the tx rows of
    `--synthetic --synthetic_drugs SWEEP_DRUGS` (the reference's drugs /
    8, as stage 1's tx run), SWEEP_EPOCHS epochs with R2 after each: one
    summary line a config with a finite best R2; the best checkpoint
    overlays onto the flagship encoder's tx module exactly; the card's
    allocated memory after the second config's cleanup within
    SWEEP_MEM_SLACK bytes of its value after the first."""
    from madrigal_tpu_torch.cli import chemcpa_sweep as cli_sweep
    from madrigal_tpu_torch.data import synthetic
    from madrigal_tpu_torch.train.transfer import overlay_stage1_checkpoint

    work = WORK / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    chem = flagship_config(NUM_LABELS).model.encoder.chemcpa
    spec = work / "sweep.json"
    spec.write_text(json.dumps({
        "fixed": {"training.num_epochs": SWEEP_EPOCHS,
                  "training.checkpoint_freq": 1,
                  "model.hparams.dim": chem.dim,
                  "model.hparams.autoencoder_width": chem.autoencoder_width,
                  "model.hparams.autoencoder_depth": chem.autoencoder_depth,
                  "model.use_drugs": False},
        "grid": {"model.hparams.autoencoder_lr": {
            "type": "choice", "options": list(SWEEP_RATES)}}}))
    # the allocated bytes after each config's cleanup (the sweep calls
    # torch.cuda.empty_cache once a config)
    after, empty_cache = [], torch.cuda.empty_cache

    def record():
        empty_cache()
        after.append(torch.cuda.memory_allocated())

    torch.cuda.empty_cache = record
    try:
        with Recorder() as rec:
            rec.wrap(synthetic, "make_dataset", keep=True)
            reset_launches()  # counts start here
            t0 = time.perf_counter()
            res = cli_sweep.main([
                "--platform", "cuda", "--synthetic", "--synthetic_drugs",
                str(SWEEP_DRUGS), "--seed", "0", "--sweep_yaml", str(spec),
                "--save_dir", str(work)])
            t_cli = time.perf_counter() - t0
            counts = read_launches()  # counts end here
    finally:
        torch.cuda.empty_cache = empty_cache
    with open(work / "sweep_results.jsonl") as f:
        lines = [json.loads(line) for line in f]
    summaries = [line["summary"] for line in lines if "summary" in line]
    evals = [line for line in lines if "test_r2" in line]
    require(len(summaries) == len(res["results"]) == len(SWEEP_RATES)
            and all(np.isfinite(s["best_r2"]) for s in summaries)
            and len(evals) == len(SWEEP_RATES) * (SWEEP_EPOCHS - 1),
            f"chemcpa_sweep: summaries {summaries}, {len(evals)} evals")
    require(len(after) == len(SWEEP_RATES)
            and abs(after[1] - after[0]) <= SWEEP_MEM_SLACK,
            f"chemcpa_sweep: allocated bytes after each config {after}")
    require(counts["bilinear_scores"] == 0,
            f"chemcpa_sweep: launches {counts}")
    # K2 carries the transposes of the embeddings' gathers
    k2_want = require_k2(counts, "chemcpa_sweep")
    # the best encoder onto the flagship encoder
    sd, cfg = load_checkpoint(res["checkpoint"])
    ds = rec.results["make_dataset"][0]
    enc = MadrigalEncoder(flagship_config(NUM_LABELS).model.encoder,
                          *kg_schema(ds.kg_node_feats, ds.kg_edge_indices))
    tx = [k for k in enc.state_dict() if k.startswith("tx_encoder.")]
    merged = overlay_stage1_checkpoint(enc.state_dict(), sd)
    require(isinstance(cfg, C.ChemCPAConfig) and tx
            and all(k in sd and torch.equal(merged[k], sd[k]) for k in tx),
            "chemcpa_sweep: the best checkpoint does not overlay onto the "
            "flagship encoder's tx module")
    emit({"phase": "chemcpa_sweep", "drugs": SWEEP_DRUGS,
          "k2_expected": k2_want, "genes": ds.tx_table.shape[2],
          "configs": len(summaries), "epochs": SWEEP_EPOCHS,
          "widths": {"dim": chem.dim, "width": chem.autoencoder_width,
                     "depth": chem.autoencoder_depth},
          "best_r2": [s["best_r2"] for s in summaries],
          "stop_reasons": [s["stop_reason"] for s in summaries],
          "best_index": res["best_index"], "tensors_overlaid": len(tx),
          "allocated_bytes_after_config": after, "launches": counts,
          "cli_s": t_cli})
    shutil.rmtree(work)
    return counts


def phase_lm_decoder(ckpt: str, z_path: str):
    """The LM-head CLI at full width: --synthetic_scale, the drug table
    from the serving phase's checkpoint (`--checkpoint`), a seeded
    paraphrase bank [LM_VARIANTS, 960, LM_DIM] (Mistral-7B's width) as
    `--text_embeddings`, project 256, MLP 512, self-attention,
    LM_EPOCHS epochs of batch LM_BATCH: the drug table equals the serving
    phase's exported embeddings within 1e-5; the loss is finite and falls
    from the first epoch to the second; the zero-shot metrics are finite;
    the saved head reloads on the CPU and scores LM_ROWS_VS_CPU eval rows
    within 1e-5 of the trainer on the card."""
    from madrigal_tpu_torch.cli import train_lm as cli_lm
    from madrigal_tpu_torch.models.lm_decoder import LMDecoder
    from madrigal_tpu_torch.train import lm_decoder as lm_lib
    from madrigal_tpu_torch.train.lm_decoder import LMDecoderTrainer

    work = WORK / "lm"
    work.mkdir(parents=True, exist_ok=True)
    bank = work / "bank.npy"
    np.save(bank, np.random.default_rng(0).standard_normal(
        (LM_VARIANTS, NUM_LABELS, LM_DIM), dtype=np.float32))
    with Recorder() as rec:
        rec.wrap(cli_common, "load_data")
        rec.wrap(lm_lib, "build_lm_table")
        rec.wrap(cli_lm, "_drug_table")
        rec.wrap(cli_lm, "_text_table")
        rec.wrap(LMDecoderTrainer, "__init__", sync=True)
        rec.wrap(LMDecoderTrainer, "train_epoch", sync=True)
        rec.wrap(LMDecoderTrainer, "evaluate", sync=True)
        reset_launches()  # counts start here
        t0 = time.perf_counter()
        res = cli_lm.main([
            "--platform", "cuda", "--synthetic_scale", "--seed", "0",
            "--checkpoint", ckpt, "--text_embeddings", str(bank),
            "--project_dim", "256", "--mlp_dim", "512",
            "--num_epochs", str(LM_EPOCHS), "--batch_size", str(LM_BATCH),
            "--save_dir", str(work)])
        t_cli = time.perf_counter() - t0
        counts = read_launches()  # counts end here
    z = np.load(z_path)
    z_err = float(np.abs(res["drug_table"] - z).max())
    # the same model's KG pass and drug encodings on the same data: the
    # same bits as the serving phase's (its sums all run on K2)
    require(res["drug_table"].shape == z.shape
            and np.array_equal(res["drug_table"], z),
            f"lm_decoder: the drug table differs from the serving phase's "
            f"embeddings by {z_err}")
    losses = res["losses"]
    require(len(losses) == LM_EPOCHS and np.isfinite(losses).all()
            and losses[1] < losses[0], f"lm_decoder: losses {losses}")
    keys = ("auroc", "auprc", "fmax", "accuracy")
    require(all(np.isfinite(m[k]) for m in res["metrics"] for k in keys),
            f"lm_decoder: zero-shot metrics {res['metrics']}")
    require(counts["bilinear_scores"] == 0, f"lm_decoder: launches {counts}")
    k2_want = require_k2(counts, "lm_decoder")  # the drug table's pass
    # the saved head on the CPU against the trainer on the card
    sd = torch.load(Path(res["path"]) / "lm_decoder.pt", weights_only=True)
    head = LMDecoder.from_state_dict(sd)
    rows = {k: v[:LM_ROWS_VS_CPU] for k, v in res["eval_table"].items()}
    card = res["trainer"].predict(rows)
    text = np.load(bank, mmap_mode="r")[0]  # predict's variant
    drug = torch.from_numpy(res["drug_table"])
    with torch.no_grad():
        cpu = torch.sigmoid(head(
            drug[rows["head"]], drug[rows["tail"]],
            torch.from_numpy(np.ascontiguousarray(text[rows["label"]])))
        ).numpy()
    cpu_err = float(np.abs(card - cpu).max())
    require(cpu_err <= 1e-5,
            f"lm_decoder: the reloaded head on the CPU differs from the "
            f"card by {cpu_err}")
    meta = json.loads((Path(res["path"]) / "lm_meta.json").read_text())
    emit({"phase": "lm_decoder", "drugs": NUM_DRUGS, "outcomes": NUM_LABELS,
          "bank": [LM_VARIANTS, NUM_LABELS, LM_DIM],
          "zero_shot_outcomes": len(meta["eval_labels"]),
          "eval_rows": len(res["eval_table"]["head"]), "epochs": LM_EPOCHS,
          "batch": LM_BATCH, "losses": losses,
          "zero_shot": [{k: m[k] for k in keys} for m in res["metrics"]],
          "drug_table_max_abs_err": z_err, "cpu_max_abs_err": cpu_err,
          "launches": counts, "k2_expected": k2_want,
          "data_s": rec.seconds["load_data"],
          "tables_s": rec.seconds["build_lm_table"],
          "drug_table_s": rec.seconds["_drug_table"],
          "text_table_s": rec.seconds["_text_table"],
          "trainer_init_s": rec.seconds["__init__"],
          "epoch_s": rec.seconds["train_epoch"],
          "evaluate_s": rec.seconds["evaluate"], "cli_s": t_cli})
    del res
    shutil.rmtree(work)
    for path in (ckpt, z_path):
        Path(path).unlink()
    return counts


def write_pairs(path: Path, rows) -> str:
    np.savetxt(path, np.asarray(rows), fmt="%d")
    return str(path)


def phase_analyze(ranks: Path):
    """The analysis CLI over a [L, N, N] float32 rank tensor (mmap): the
    self-combo diagonal, pair lookups, the gmean of ANALYZE_AGG_LABELS
    outcomes with its top ANALYZE_TOPK novel pairs (a known-pair mask
    excluded), an enrichment of candidate pairs, and a binary external
    validation, alone and as the cross-validated AUROC over
    ANALYZE_CV_LABELS outcomes. Its standard output is captured, so that
    each line this script prints stays one JSON object. The diagonal and
    the top-k values against numpy on the same mmap, exactly; no
    scikit-learn, pandas or pyyaml loaded."""
    from madrigal_tpu_torch.cli import analyze as cli_analyze

    work = ranks.parent / "analyze"
    work.mkdir(parents=True, exist_ok=True)
    t = np.load(ranks, mmap_mode="r")
    L, n, _ = t.shape
    rng = np.random.RandomState(0)
    labels = sorted(rng.choice(L, ANALYZE_CV_LABELS, replace=False).tolist())
    agg = labels[:ANALYZE_AGG_LABELS]
    known = rng.rand(n, n) < 0.01
    np.save(work / "known.npy", known)
    cand = write_pairs(work / "cand.csv", rng.randint(0, n, (50, 2)))
    val_pairs = rng.randint(0, n, (200, 2))
    val = write_pairs(work / "val.csv", np.column_stack(
        [val_pairs, rng.rand(200) < 0.3]))
    pairs = ["0:1", f"7:{n - 1}", f"{n // 2}:3"]
    label_list = ",".join(map(str, labels))
    runs = {
        "self_combo": ["--self_combo", str(work / "sc.npy")],
        "pairs": ["--pairs", *pairs, "--labels", label_list],
        "aggregate_topk": ["--aggregate", "gmean", "--labels",
                           ",".join(map(str, agg)), "--out",
                           str(work / "agg.npy"), "--topk",
                           str(ANALYZE_TOPK), "--known",
                           str(work / "known.npy")],
        "enrich": ["--label", str(labels[0]), "--enrich", cand],
        "validate": ["--label", str(labels[0]), "--validate", val],
        "cv_auroc": ["--labels", label_list, "--cv_auroc", "--validate",
                     val],
    }
    out, seconds = {}, {}
    reset_launches()  # counts start here
    for name, args in runs.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_analyze.main(["--tensor", str(ranks), *args])
        seconds[name] = time.perf_counter() - t0
        out[name] = json.loads(buf.getvalue())
    counts = read_launches()  # counts end here
    # numpy on the same mmap
    diag = np.stack([np.diagonal(t[l]) for l in range(L)])
    require(np.array_equal(np.load(work / "sc.npy"), diag),
            "analyze: the self-combo diagonal differs from numpy's")
    want = [[float(t[l][int(a), int(b)]) for a, b in
             (p.split(":") for p in pairs)] for l in labels]
    require(out["pairs"]["pairs"]["values"] == want,
            "analyze: the pair values differ from numpy's")
    acc = np.zeros((n, n))
    with np.errstate(divide="ignore"):
        for l in agg:
            acc += np.log(np.asarray(t[l], np.float64))
    gm = np.exp(acc / len(agg))
    valid = np.tri(n, k=-1, dtype=bool) & ~(known | known.T)
    top = np.sort(gm[valid])[::-1][:ANALYZE_TOPK]
    got = out["aggregate_topk"]["topk"]
    require(got["values"] == top.tolist()
            and all(valid[a, b] and gm[a, b] == v
                    for (a, b), v in zip(got["pairs"], got["values"])),
            "analyze: the top-k pairs differ from numpy's")
    require(np.isfinite(out["enrich"]["enrichment"]["pvalue"])
            and out["validate"]["validation"]["kind"] == "binary"
            and np.isfinite(out["validate"]["validation"]["auroc"])
            and 0 <= out["cv_auroc"]["cv_auroc"]["auroc"] <= 1
            and out["cv_auroc"]["cv_auroc"]["labels"] == labels,
            f"analyze: {out['enrich']}, {out['validate']}, "
            f"{out['cv_auroc']}")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("sklearn", "pandas", "yaml"))
    require(not loaded, f"analyze: loaded {loaded}")
    require(counts == {"bilinear_scores": 0, "sorted_segment_sum": 0},
            f"analyze: launches {counts}")
    emit({"phase": "analyze", "tensor": [L, n, n],
          "labels": labels, "topk_values": got["values"][:3],
          "enrichment_pvalue": out["enrich"]["enrichment"]["pvalue"],
          "validation_auroc": out["validate"]["validation"]["auroc"],
          "cv_auroc": out["cv_auroc"]["cv_auroc"], "launches": counts,
          "query_s": seconds})
    shutil.rmtree(work)
    return counts


def phase_pretrain_embeds(enc_cfg, ds, before: dict, after: dict):
    """`analysis.pretrain_embeds.pretrain_embedding_shift` of the encoder
    `enc_cfg` on `ds` (full scale) between two state_dicts, for
    EMBED_DRUGS full-modality drugs with PCA: the alignments and
    coordinates finite; EMBED_DRUGS_VS_CPU drugs' rows under `after`
    against the same encoder on the CPU within 1e-5 of their largest
    entry (the CPU takes the card's KG drug table: the full-scale HGT
    pass alone on the CPU would take most of the phase's budget, and the
    reference_ckpt phase holds it to the CPU)."""
    from madrigal_tpu_torch.analysis import pretrain_embeds as pe
    from madrigal_tpu_torch.eval.evaluate_pt import (
        DEFAULT_EVAL_MODALITY_INDICES,
        encode_single_modality,
        kg_table,
    )

    coll = DDICollator(ds, split="train", seed=0, device="cuda")
    kg = coll.kg_batch()
    enc = MadrigalEncoder(enc_cfg, *kg_schema(ds.kg_node_feats,
                                              ds.kg_edge_indices)).cuda()
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    res = pe.pretrain_embedding_shift(enc, before, after, coll, kg,
                                      n_drugs=EMBED_DRUGS, method="pca")
    t_shift = time.perf_counter() - t0
    counts = read_launches()  # counts end here
    align = res["alignment"]
    require(len(res["drugs"]) == EMBED_DRUGS
            and all(np.isfinite(v) for v in align.values())
            and np.isfinite(res["coords_before"]).all()
            and np.isfinite(res["coords_after"]).all()
            and res["projection"] == "pca",
            f"pretrain_embeds: alignment {align}, {len(res['drugs'])} "
            "drugs")
    require(counts["bilinear_scores"] == 0,
            f"pretrain_embeds: launches {counts}")
    k2_want = require_k2(counts, "pretrain_embeds")
    drugs = res["drugs"][:EMBED_DRUGS_VS_CPU]
    table = kg_table(enc, kg)
    cpu_enc = copy.deepcopy(enc).cpu()
    cpu_coll = DDICollator(ds, split="train", seed=0, device="cpu")
    err, scale = 0.0, 0.0
    for mi in DEFAULT_EVAL_MODALITY_INDICES:
        zg, vg = encode_single_modality(enc, coll, kg, drugs, mi,
                                        kg_drug_table=table)
        zc, vc = encode_single_modality(cpu_enc, cpu_coll, None, drugs, mi,
                                        kg_drug_table=table.cpu())
        require(np.array_equal(vg, vc), "pretrain_embeds: valid drugs")
        if len(vc):
            err = max(err, float(np.abs(zg - zc).max()))
            scale = max(scale, float(np.abs(zc).max()))
    require(err <= 1e-5 * scale,
            f"pretrain_embeds: the card's rows differ from the CPU's by "
            f"{err} (largest {scale})")
    emit({"phase": "pretrain_embeds", "drugs": [int(d) for d in
                                                res["drugs"]],
          "rows": int(len(res["modality"])), "alignment": align,
          "rows_vs_cpu_max_abs_err": err, "rows_vs_cpu_largest": scale,
          "launches": counts, "k2_expected": k2_want, "shift_s": t_shift})
    return counts


def trace_summary(log_dir: Path, symbols) -> dict:
    """From the Chrome trace in `log_dir`: the window (first to last
    event), the device's busy time in it (the union of its kernels,
    copies and sets), the TOP_DEVICE_OPS device operations with the most
    time, and the time of the kernels whose names hold each of
    `symbols`."""
    (path,) = sorted(log_dir.glob("trace_*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -np.inf
    for s, d in sorted((e["ts"], e["dur"]) for e in dev):
        if s + d > end:
            busy += s + d - max(s, end)
            end = s + d
    by_name = {}
    for e in dev:
        us, k = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_DEVICE_OPS]
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0), "device_ops": len(dev),
            "top": [{"name": name[:120], "ms": us / 1e3, "count": k}
                    for name, (us, k) in top],
            "kernel_ms": {s: sum(e["dur"] for e in dev if s in e["name"])
                          / 1e3 for s in symbols}}


def encoder_states(cl_last: str) -> tuple:
    """(the encoder's config, its state_dict) of a stage-2 checkpoint."""
    sd, cfg = load_checkpoint(cl_last)
    pre = "base_encoder."
    return cfg.encoder, {k[len(pre):]: v for k, v in sd.items()
                         if k.startswith(pre)}


def aux_setup() -> dict:
    """For `--aux`, what the five phases take from earlier phases of
    `main`, made here at the same sizes: the reference-scale dataset (seed
    0); a flagship model from seed 0 saved as a checkpoint, with its drug
    embeddings and decoder weight (the serving phase's); a seeded rank
    tensor in the ensemble's layout and shape (symmetric, zero diagonal,
    [120, 855, 855] float32); and two seeded flagship encoders' state_dicts
    (the pretrain phase's before and after)."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    ds = make_reference_scale_dataset(seed=0)
    cfg = flagship_config(NUM_LABELS)
    model = random_model(cfg, ds, seed=0).eval()
    ckpt, emb = str(WORK / "flagship.pt"), str(WORK / "z.npy")
    save_checkpoint(ckpt, model, cfg)
    model.cuda()
    coll = DDICollator(ds, split="train", seed=0, device="cuda")
    z = P.embed_all_drugs(model, coll, coll.kg_batch())
    np.save(emb, z)
    w_sym = P.decoder_weight(model).cpu()
    del model, coll
    kw = reference_scale_kwargs(ENSEMBLE_SHRINK)
    L, n = kw["num_labels"], kw["num_drugs"]
    ranks = WORK / "ensemble" / "ranks.npy"
    ranks.parent.mkdir()
    t = np.random.default_rng(0).random((L, n, n), dtype=np.float32)
    t += t.transpose(0, 2, 1)
    t /= 2
    t[:, np.arange(n), np.arange(n)] = 0
    np.save(ranks, t)
    del t
    enc = MadrigalEncoder(cfg.model.encoder,
                          *kg_schema(ds.kg_node_feats, ds.kg_edge_indices))
    states = [{k: v.clone() for k, v in init_weights(
        enc, torch.Generator().manual_seed(seed)).state_dict().items()}
        for seed in (1, 2)]
    return {"ds": ds, "ckpt": ckpt, "emb": emb, "z": z, "w_sym": w_sym,
            "ranks": ranks, "enc_cfg": cfg.model.encoder,
            "before": states[0], "after": states[1]}


AUX_PHASES = ("lm_decoder", "analyze", "chemcpa_sweep", "profile",
              "pretrain_embeds")


def phase_profile(w_sym: torch.Tensor, z: np.ndarray):
    """`utils.profiling.trace` around one K1 call at the serving shape
    (LABEL_CHUNK x SERVE_HEADS x 6,843 f32, the serving model's decoder
    weight and embeddings) and around one stage-3 training step of the
    flagship at the training phase's shapes (the reference scale /
    SYNTHETIC_TRAIN_SHRINK, the HGT remat), after one
    untraced step: each trace must name K1's kernel (`gemm_f32`) or K2's
    (`segment_sum_kernel`); each trace's top device operations and busy
    share; StepTimer's summary over PROFILE_STEPS more steps;
    memory_stats()."""
    from madrigal_tpu_torch.utils import profiling

    work = WORK / "profile"
    f32 = torch.float32
    zh = torch.from_numpy(z[:SERVE_HEADS]).cuda()
    zt = torch.from_numpy(z).cuda()
    w = w_sym[:LABEL_CHUNK].cuda()
    ds = make_reference_scale_dataset(
        seed=0, **reference_scale_kwargs(SYNTHETIC_TRAIN_SHRINK))
    cfg = flagship_config(ds.num_labels)
    enc = cfg.model.encoder
    cfg = dataclasses.replace(cfg, label_chunk_triples=LABEL_CHUNK,
                              model=dataclasses.replace(
                                  cfg.model, encoder=dataclasses.replace(
                                      enc, hgt=dataclasses.replace(
                                          enc.hgt, remat_edge_types=True))))
    batch, kg = DDICollator(ds, split="train", seed=0, device="cuda",
                            kg_src_sort=True)(split_rows(ds)["train"])
    trainer = FinetuneTrainer(cfg, batch, kg,
                              random_model(cfg, ds, seed=0).cuda())
    torch.cuda.synchronize()
    reset_launches()  # counts start here
    with profiling.trace(str(work / "k1")):
        with profiling.annotate("k1_serving_chunk"):
            scores = bilinear.bilinear_scores(zh, zt, w, f32, f32)
        torch.cuda.synchronize()
    trainer.train_epoch()  # untraced: the step's first allocations
    with profiling.trace(str(work / "step")):
        with profiling.annotate("training_step"):
            losses = trainer.train_epoch()
        torch.cuda.synchronize()
    timer = profiling.StepTimer()
    for _ in range(PROFILE_STEPS):
        timer.start()
        trainer.train_epoch()
        timer.stop(list(trainer.model.parameters())[:1])
    counts = read_launches()  # counts end here
    traces = {"k1": trace_summary(work / "k1", ("gemm_f32",)),
              "step": trace_summary(work / "step", ("segment_sum_kernel",))}
    k2_want = require_k2(counts, "profile")
    require(counts["bilinear_scores"] == 1
            and all(np.isfinite(v) for v in losses.values())
            and torch.isfinite(scores).all(),
            f"profile: launches {counts}, losses {losses}")
    for name, tr in traces.items():
        require(all(ms > 0 for ms in tr["kernel_ms"].values()),
                f"profile: the {name} trace names no kernel of "
                f"{list(tr['kernel_ms'])}")
    emit({"phase": "profile", "k1_shape": [LABEL_CHUNK, SERVE_HEADS,
                                           NUM_DRUGS],
          "step_shrink": SYNTHETIC_TRAIN_SHRINK, "traces": traces,
          "step_timer": timer.summary(), "memory": profiling.memory_stats(),
          "launches": counts, "k2_expected": k2_want})
    del trainer, batch, kg
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return counts


# --train_memory: each choice of memory flags for the training run
MEMORY_CHOICES = [
    [],
    TRAIN_MEMORY_FLAGS,
    ["--fusion_remat"],
    ["--fusion_remat", *TRAIN_MEMORY_FLAGS],
    ["--fusion_remat", "--fusion_remat_policy", "none", *TRAIN_MEMORY_FLAGS],
]


def memory_choice(flags) -> dict:
    """2 epochs of the training run under `flags`: epoch seconds and peak
    device memory, or the out-of-memory error."""
    save_dir = WORK / "train_memory"
    torch.cuda.reset_peak_memory_stats()
    try:
        res = cli_train_ddi.main(train_argv(flags, 2, save_dir))
        out = {"epoch_s": res["epoch_seconds"],
               "data_build_s": res["data_seconds"]}
    except torch.cuda.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).splitlines()[0]}
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"phase": "train_memory", "shrink": TRAIN_SHRINK,
            "memory_flags": flags, **out,
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train_memory() -> None:
    """Each of MEMORY_CHOICES in a process of its own, so that one that
    runs out of memory leaves nothing behind for the next."""
    for flags in MEMORY_CHOICES:
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--memory_choice",
             json.dumps(flags)], capture_output=True, text=True, timeout=600)
        lines = res.stdout.strip().splitlines()
        require(res.returncode == 0 and lines,
                f"memory choice {flags} failed:\n{res.stderr[-3000:]}")
        print(lines[-1], flush=True)


def phase_build(native: bool = False) -> None:
    """Both kernels from their sources, the two nvcc processes started
    together; nvcc's -Xptxas -v report goes to standard output. With
    `native`, the SMILES featurizer's library is built by g++ beside
    them."""
    seconds = {}
    with ThreadPoolExecutor(1) as pool:
        if native:
            t0 = time.perf_counter()
            lib = pool.submit(native_featurizer.build_native)
        libs = _build.build(["bilinear", "segment_sum"], verbose=True,
                            seconds=seconds)
        for kernel, src in (("bilinear_scores", "bilinear"),
                            ("sorted_segment_sum", "segment_sum")):
            emit({"phase": "build", "kernel": kernel,
                  "library": libs[src].name, "seconds": seconds[src]})
        if native:
            emit({"phase": "build", "library": Path(lib.result()).name,
                  "seconds": time.perf_counter() - t0})


ALT_PHASES = ("alt_small", "alt_encoders", "bf16_train", "reference_ckpt")


def alt_phases(run, ds) -> tuple:
    """The phases of the alternative encoders, the bf16 mode and the
    reference's checkpoints (ALT_PHASES), through `run`, on the
    reference-scale dataset `ds`: (each one's launch counts, K2's timing
    row on the bf16 step's rows)."""
    paths = {"alt_small": run("alt_small", phase_alt_small),
             "alt_encoders": run("alt_encoders", phase_alt_encoders, ds)}
    paths["bf16_train"], k2_bf16 = run("bf16_train", phase_bf16_train, ds)
    paths["reference_ckpt"] = run("reference_ckpt", phase_reference_ckpt,
                                  ds)
    return paths, k2_bf16


def main(argv) -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA GPU: "
                 "torch.cuda.is_available() is false")
    pkg = Path(madrigal_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        sys.exit(f"chip_smoke.py must run beside its package; found {pkg}")
    resolve_device("cuda")  # TF32 off: float32 stays float32
    if argv[:1] == ["--parallel_rank"]:
        return parallel_rank(Path(argv[1]))
    if argv[:1] == ["--memory_choice"]:
        emit(memory_choice(json.loads(argv[1])))
        return 0
    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"phase": "device", "nvidia_smi": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    if argv == ["--train_memory"]:
        _build.build(["segment_sum"])  # not inside the first choice's time
        phase_train_memory()
        print(gpu_line(), flush=True)
        return 0
    if argv == ["--pretrain"]:
        wall = {}
        for name, fn in (("build", lambda: _build.build(["segment_sum"])),
                         ("pretrain_small", phase_pretrain_small),
                         ("pretrain", phase_pretrain),
                         ("pretrain_final_embeds",
                          phase_pretrain_final_embeds)):
            t0 = time.perf_counter()
            fn()
            wall[name] = time.perf_counter() - t0
        emit({"phase": "wall", "seconds": wall})
        shutil.rmtree(WORK, ignore_errors=True)
        print(gpu_line(), flush=True)
        return 0
    if argv == ["--stage1"]:
        wall = {}
        for name, fn in (("build", lambda: _build.build(["segment_sum"])),
                         ("stage1_small", phase_stage1_small),
                         ("stage1", phase_stage1)):
            t0 = time.perf_counter()
            fn()
            wall[name] = time.perf_counter() - t0
        emit({"phase": "wall", "seconds": wall})
        shutil.rmtree(WORK, ignore_errors=True)
        print(gpu_line(), flush=True)
        return 0
    if argv not in ([], ["--kernels"], ["--alt"], ["--aux"],
                    ["--parallel"]):
        sys.exit(f"unknown arguments {argv}: chip_smoke.py takes none, "
                 "--kernels, --pretrain, --stage1, --alt, --aux, "
                 "--parallel or --train_memory")

    wall = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        wall[name] = time.perf_counter() - t0
        return res

    if argv == ["--aux"]:
        run("build", phase_build)
        aux = run("aux_setup", aux_setup)
        paths = {"lm_decoder": run("lm_decoder", phase_lm_decoder,
                                   aux["ckpt"], aux["emb"]),
                 "analyze": run("analyze", phase_analyze, aux["ranks"]),
                 "chemcpa_sweep": run("chemcpa_sweep", phase_chemcpa_sweep),
                 "profile": run("profile", phase_profile, aux["w_sym"],
                                aux["z"]),
                 "pretrain_embeds": run("pretrain_embeds",
                                        phase_pretrain_embeds,
                                        aux["enc_cfg"], aux["ds"],
                                        aux["before"], aux["after"])}
        emit({"phase": "wall", "seconds": wall, "launches_by_path": paths,
              "budget": {"aux_s": sum(wall[p] for p in AUX_PHASES),
                         "aux_limit_s": AUX_BUDGET_S}})
        shutil.rmtree(WORK, ignore_errors=True)
        print(gpu_line(), flush=True)
        return 0
    if argv == ["--parallel"]:
        run("build", phase_build)
        paths = {"parallel_small": run("parallel_small",
                                       phase_parallel_small)}
        refs = run("parallel_reference", parallel_reference,
                   WORK / "parallel_reference")
        paths["parallel"] = run("parallel", phase_parallel, *refs)
        shutil.rmtree(WORK, ignore_errors=True)
        emit({"phase": "wall", "seconds": wall, "launches_by_path": paths,
              "budget": {"parallel_s": wall["parallel_small"]
                         + wall["parallel"],
                         "parallel_limit_s": PARALLEL_BUDGET_S}})
        print(gpu_line(), flush=True)
        return 0
    if argv == ["--alt"]:
        run("build", phase_build)
        alt_phases(run, run("data", make_reference_scale_dataset))
        emit({"phase": "wall", "seconds": wall,
              "budget": {"alt_s": sum(wall[p] for p in ALT_PHASES),
                         "alt_limit_s": ALT_BUDGET_S}})
        shutil.rmtree(WORK, ignore_errors=True)
        print(gpu_line(), flush=True)
        return 0
    run("build", phase_build, argv == [])
    if argv == ["--kernels"]:
        phase_kernels()
        phase_k2_kernels()
        print(gpu_line(), flush=True)
        return 0
    k1_checks = run("kernels", phase_kernels)
    k2_checks = run("k2_kernels", phase_k2_kernels)
    run("small", phase_small)
    serving, model, z, ds, ckpt, emb, z_again = run("serving",
                                                    phase_serving)
    paths = {"serving": serving}
    paths["ranks"], finish_ranks, ranks, rank_w = run("ranks", phase_ranks,
                                                      model, z, z_again)
    del z_again
    w_sym = P.decoder_weight(model).cpu()  # the profile phase's K1 call
    del model
    paths["parallel_small"] = run("parallel_small", phase_parallel_small)
    # the alternative encoders, the bf16 mode and the reference's
    # checkpoints, on the serving phase's dataset
    alt_paths, k2_bf16 = alt_phases(run, ds)
    paths.update(alt_paths)
    del ds
    # the rank references run on the host beside the next four phases
    paths["predict_ensemble"], ensemble_ranks = run(
        "predict_ensemble", phase_predict_ensemble)
    paths["analyze"] = run("analyze", phase_analyze, ensemble_ranks)
    # the multi-GPU paths at full width: the ranks phase's ranks, the
    # ensemble's checkpoints and unsharded export
    paths["parallel"] = run("parallel", phase_parallel, ranks, z, rank_w,
                            ensemble_ranks.parent)
    del rank_w
    shutil.rmtree(ensemble_ranks.parent)
    run("train_small", phase_train_small)
    run("pretrain_small", phase_pretrain_small)
    run("stage1_small", phase_stage1_small)
    paths["chemcpa_sweep"] = run("chemcpa_sweep", phase_chemcpa_sweep)
    paths["training"] = run("training", phase_training)
    # the LM head on the serving phase's checkpoint and embeddings (after
    # the phases that build optimizers: the process's first one imports
    # torch._dynamo, seconds of host time whichever phase pays them)
    paths["lm_decoder"] = run("lm_decoder", phase_lm_decoder, ckpt, emb)
    paths["profile"] = run("profile", phase_profile, w_sym, z)
    del w_sym, z
    # stage 1 -> stage 2 -> (data_dir) stage 3 -> serving, on the card
    paths["stage1"], stage1 = run("stage1", phase_stage1)
    paths["pretrain"], stage2, start, pre_ds = run("pretrain",
                                                   phase_pretrain, stage1)
    enc_cfg, after = encoder_states(stage2)
    paths["pretrain_embeds"] = run("pretrain_embeds", phase_pretrain_embeds,
                                   enc_cfg, pre_ds, start, after)
    del start, after, pre_ds
    shutil.rmtree(WORK / "stage1")
    paths["pretrain_final_embeds"] = run("pretrain_final_embeds",
                                         phase_pretrain_final_embeds)
    # collected before the phases that write and parse the large csv
    # files, which would otherwise share the host's cores with them
    run("ranks_references", finish_ranks)
    # stage 3 warm-started from the card's own stage-2 checkpoint
    paths["data_dir"], paths["predict_data_dir"] = run(
        "data_dir", phase_data_dir, stage2)
    shutil.rmtree(WORK / "pretrain")
    paths["all_train"] = run("all_train", phase_all_train)
    main_s = time.perf_counter() - t_start
    stage2_s = sum(wall[p] for p in ("pretrain_small", "pretrain",
                                     "pretrain_final_embeds"))
    stage1_s = wall["stage1_small"] + wall["stage1"]
    alt_s = sum(wall[p] for p in ALT_PHASES)
    aux_s = sum(wall[p] for p in AUX_PHASES)
    parallel_s = wall["parallel_small"] + wall["parallel"]
    emit({"phase": "wall", "seconds": wall, "main_s": main_s,
          "budget": {"stage2_s": stage2_s, "stage2_limit_s": STAGE2_BUDGET_S,
                     "stage2_met": stage2_s <= STAGE2_BUDGET_S,
                     "stage1_s": stage1_s, "stage1_limit_s": STAGE1_BUDGET_S,
                     "stage1_met": stage1_s <= STAGE1_BUDGET_S,
                     "alt_s": alt_s, "alt_limit_s": ALT_BUDGET_S,
                     "alt_met": alt_s <= ALT_BUDGET_S,
                     "aux_s": aux_s, "aux_limit_s": AUX_BUDGET_S,
                     "aux_met": aux_s <= AUX_BUDGET_S,
                     "parallel_s": parallel_s,
                     "parallel_limit_s": PARALLEL_BUDGET_S,
                     "parallel_met": parallel_s <= PARALLEL_BUDGET_S,
                     "main_limit_s": MAIN_BUDGET_S,
                     "main_met": main_s <= MAIN_BUDGET_S}})

    def entry(name, source, replaces, checks, shape_keys, extra=()):
        timed = [r for r in checks if "ms" in r]
        by_path = {p: c[name] for p, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": timed[-1]["max_abs_err"],
                "ms": timed[-1]["ms"], "plain_ms": timed[-1]["plain_ms"],
                "bound_ms": timed[-1]["bound_ms"],
                "bound_by": timed[-1]["bound_by"],
                "library_ms": timed[-1]["library_ms"],
                "timed_at": {k: timed[-1][k] for k in shape_keys},
                "timings": timed + list(extra)}

    # K1: timed last at the all-pairs bench shape, bf16 in and out, and
    # launched on the serving, rank, ensemble and profile paths; K2: timed
    # last at the full-scale training run's largest edge type, at the
    # shape that run gives it, and launched on the training, stage-1,
    # stage-2 and profile paths (the LM head, the sweep, analyze and
    # pretrain_embeds launch neither: their counts stay in the line).
    # `launches` sums the paths,
    # each counted from 0 just before it and read just after
    emit({"kernels": [
        entry("bilinear_scores", "madrigal_tpu_torch/csrc/bilinear.cu",
              "madrigal_tpu/ops/bilinear_pallas.py:35", k1_checks,
              ("L", "M", "N", "compute", "out")),
        entry("sorted_segment_sum", "madrigal_tpu_torch/csrc/segment_sum.cu",
              "madrigal_tpu/ops/segment_pallas.py:62", k2_checks,
              ("edge_type", "shrink", "E", "E_real", "N", "W", "in"),
              extra=[k2_bf16])]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
