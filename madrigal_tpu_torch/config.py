"""Configuration system for Madrigal-TPU.

Dataclass-based equivalent of the reference's argparse + YAML-override config
stack (reference: madrigal/parse_args.py:5-433). Every hyperparameter the
reference exposes has a field here; `from_yaml` / `from_args` provide the same
layering (defaults -> YAML -> CLI overrides -> derived-arg validation).

Configs are plain frozen dataclasses so they can be embedded verbatim inside
checkpoints (the reference embeds `encoder_configs`/`model_configs` in its
checkpoints and reconstructs models purely from them at inference time --
reference: madrigal/evaluate/predict.py:20-23, train_ddi_batch.py:393-412).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

from .constants import (
    CV_INPUT_DIM,
    FEATURE_DIM,
    MOL_DIM,
    NUM_CELL_LINES,
    NUM_MODALITIES,
    NUM_NON_TX_MODALITIES,
    TX_INPUT_DIM,
)

FINETUNE_MODES = (
    "ablation_str_str",
    "ablation_kg_kg_subset",
    "ablation_kg_kg_padded",
    "ablation_cv_cv_padded",
    "ablation_tx_tx_padded",
    "ablation_str_random_str+kg_full_sample",
    "ablation_str_random_str+cv_full_sample",
    "ablation_str_random_str+tx_full_sample",
    "ablation_str_random_str+kg+cv_full_sample",
    "ablation_str_random_str+kg+tx_full_sample",
    "ablation_str_random_str+cv+tx_full_sample",
    "str_full",
    "full_full",
    "double_random",
    "str_random_sample",
    "str_str+random_sample",
    "full_str+random_sample",
)

PRETRAIN_MODES = (
    "double_random",
    "str_center",
    "str_center_comb",
    "str_center_uni",
    "str_kg",
)


@dataclass(frozen=True)
class GINConfig:
    """Structure (molecular graph) encoder. Reference: parse_args.py:31-37."""
    hidden_dims: tuple = (128, 128, 128)  # + [feature_dim] appended as final layer
    edge_input_dim: int = 18
    num_mlp_layer: int = 3
    eps: float = 0.0
    learn_eps: bool = True
    batch_norm: bool = True
    actn: str = "relu"
    readout: str = "mean"
    atom_dim: int = MOL_DIM


@dataclass(frozen=True)
class GATConfig:
    """Alternate structure encoder. Reference: parse_args.py:23-29."""
    hidden_dims: tuple = (128, 128, 128)
    edge_input_dim: int = 18
    att_heads: int = 4
    negative_slope: float = 0.2
    batch_norm: bool = False
    actn: str = "relu"
    readout: str = "mean"
    atom_dim: int = MOL_DIM


@dataclass(frozen=True)
class HGTConfig:
    """KG encoder. Reference: parse_args.py:52-55.

    softmax_scope selects the attention normalization semantics, which
    changed between PyG versions (the reference's code passes group='sum',
    the PyG <=2.2 API, while its env pins torch-geometric 2.3.1 whose
    rewritten HGTConv removed `group` and normalizes globally):
      * 'per_edge_type' (default): softmax over each edge type's incoming
        edges separately, then `group`-aggregate across edge types
        (PyG <=2.2 HGTConv).
      * 'global': one softmax over ALL incoming edges of a destination
        node across edge types, summed (PyG 2.3.x HGTConv).
    """
    hidden_dim: int = 128
    num_layers: int = 2
    att_heads: int = 4
    group: str = "sum"
    softmax_scope: str = "per_edge_type"
    # rematerialize each edge type's message pass in the backward: without
    # it, training over a full-scale KG (8.3M edges, 17 types) keeps every
    # type's [E, H, D] attention buffers alive simultaneously (~17 GB
    # padded). per_edge_type scope only.
    remat_edge_types: bool = False
    # graph-parallel message passing: when set to a mesh axis name, the
    # conv expects to run inside shard_map with every edge array sharded
    # over that axis (node tables + weights replicated) and merges segment
    # reductions with psum/pmax collectives. See parallel/kg_shard.py.
    shard_axis: Optional[str] = None
    # throughput mode for the edge-level message pipeline: 'bfloat16'
    # halves the HBM traffic of the [E, H, D] gather/scatter stream (the
    # full-KG forward is bandwidth-bound). Params, attention-softmax
    # statistics, and segment-sum accumulation stay float32. Default
    # float32 = exact reference-parity numerics.
    compute_dtype: str = "float32"
    # use the source-sorted MXU backward for the src gathers when the KG
    # batch carries the layout (build_kg_batch(src_sort=True)): the
    # gather's transpose becomes a permutation gather + Pallas one-hot
    # segment sum (ops/segment_pallas.py) instead of XLA's unsorted
    # [E]-row scatter-add (measured 37.5 vs 133.6 ms at [8.3M, 128] f32,
    # scripts/segment_bench.py). f32/bf16 only; f64 parity paths fall
    # back automatically.
    src_sorted_bwd: bool = True


@dataclass(frozen=True)
class HANConfig:
    """Alternate KG encoder. Reference: parse_args.py:46-50."""
    hidden_dim: int = 128
    num_layers: int = 1
    att_heads: int = 4
    negative_slope: float = 0.2
    dropout: float = 0.2


@dataclass(frozen=True)
class RGCNConfig:
    """Alternate KG encoder (reference models.py:99-117)."""
    hidden_dim: int = 128
    num_layers: int = 2
    num_bases: int = 8
    aggr: str = "mean"
    actn: str = "relu"


@dataclass(frozen=True)
class MLPEncoderConfig:
    """Tabular modality encoder (cv / bs / mlp-tx). Reference: parse_args.py:58-74."""
    input_dim: int = CV_INPUT_DIM
    hidden_dims: tuple = (512, 256)
    dropout: float = 0.2
    norm: Optional[str] = None  # 'bn' | 'ln' | None
    actn: str = "relu"
    order: str = "nd"  # norm->dropout or dropout->norm


@dataclass(frozen=True)
class ChemCPAConfig:
    """Transcriptomics encoder (chemCPA predict path).

    Reference: madrigal/chemcpa/chemCPA/model.py:290-712 and the flagship
    config configs/chemcpa/chemcpa_finetune_configs.yaml.
    """
    num_genes: int = TX_INPUT_DIM
    dim: int = 128
    autoencoder_width: int = 512
    autoencoder_depth: int = 2
    embedding_encoder_width: int = 256
    embedding_encoder_depth: int = 3
    dosers_width: int = 32
    dosers_depth: int = 4
    adversary_width: int = 128
    adversary_depth: int = 2
    doser_type: str = "amortized"  # 'amortized' | 'sigm' | 'logsigm' | 'mlp' | None
    decoder_activation: str = "linear"
    use_drugs: bool = False  # flagship config: model.use_drugs=false
    num_drugs: int = 0  # only used when use_drugs
    drug_embedding_dim: int = 200  # rdkit2D normalized descriptor width
    num_covariates: int = NUM_CELL_LINES
    dropout: float = 0.4  # only used during stage-1 adaptation training
    disable_adv: bool = True  # adversaries only exist for stage-1 training
    # the reference's drug_embeddings hold FROZEN rdkit2D descriptors
    # (chemCPA/embedding.py:10-20); training must exclude them from the
    # optimizer. Set False only for a deliberately trainable table.
    freeze_drug_embeddings: bool = True


@dataclass(frozen=True)
class FusionConfig:
    """Transformer fusion. Reference: parse_args.py:85-95 + models.py:352-455."""
    num_layers: int = 3
    att_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 512
    dropout: float = 0.2
    actn: str = "gelu"
    norm_first: bool = False
    agg: str = "x-attn"  # 'mean' | 'max' | 'cls' | 'x-attn'
    num_tx_bottlenecks: int = 0
    # recompute each transformer layer in the backward (memory knob for
    # full-batch training at reference scale: the flagship 2048-latent
    # fusion's saved activations over 6843x21 tokens dominate HBM)
    remat: bool = False
    # with remat: 'dots' (default) saves the Dense outputs (QKV/out
    # projections, both FFN matmuls) and recomputes only attention
    # einsums + elementwise -- measured ~4% faster epochs than None
    # (recompute everything) in both production modes at reference scale
    # for a few [chunk, S, latent] buffers per layer
    # (models/attention.py; docs/EPOCH_PROFILE.md rp sweep). None is the
    # max-memory-savings fallback. Two reference-scale configs need it
    # noted: (a) full_full + hgt.remat_edge_types=True + dots overflows
    # HBM by ~10 MB in the fused step -- pair dots with
    # remat_edge_types=False there (faster anyway), or set policy None;
    # (b) split_forward_grads + remat_edge_types=False + dots exceeds
    # the remote XLA compile helper (keep HGT remat in split mode).
    # 'all' (everything_saveable) saves every residual -- the remat-off
    # backward (zero recompute) inside a compile-helper-safe
    # checkpointed-layer program; costs the most activation memory
    # (scripts/train_scale_bench.py --sweep rp3).
    remat_policy: str | None = "dots"
    # 'bfloat16' runs attention/FFN matmul activations in bf16 (params,
    # LayerNorms, softmax, residual stream stay f32). Throughput opt-in;
    # default float32 = exact reference-parity numerics.
    compute_dtype: str = "float32"

    @property
    def latent_dim(self) -> int:
        return self.att_heads * self.head_dim


@dataclass(frozen=True)
class ProjectorConfig:
    """Unimodal projector / fuser MLPs. Reference: parse_args.py:98-102."""
    hidden_dims: tuple = (512, 512)
    dropout: float = 0.2
    norm: Optional[str] = "ln"
    actn: str = "relu"
    order: str = "nd"


@dataclass(frozen=True)
class EncoderConfig:
    """Full per-drug multimodal encoder (NovelDDIEncoder analog).

    Reference: madrigal/models/models.py:607-899.
    """
    feature_dim: int = FEATURE_DIM
    str_encoder: str = "gin"  # 'gin' | 'gat'
    gin: GINConfig = field(default_factory=GINConfig)
    gat: GATConfig = field(default_factory=GATConfig)
    kg_encoder: str = "hgt"  # 'hgt' | 'han' | 'rgcn'
    hgt: HGTConfig = field(default_factory=HGTConfig)
    han: HANConfig = field(default_factory=HANConfig)
    rgcn: RGCNConfig = field(default_factory=RGCNConfig)
    cv_encoder: str = "mlp"
    cv: MLPEncoderConfig = field(default_factory=MLPEncoderConfig)
    extra_tabular: dict = field(default_factory=dict)  # mod name -> MLPEncoderConfig
    tx_encoder: str = "chemcpa"  # 'chemcpa' | 'mlp'
    chemcpa: ChemCPAConfig = field(default_factory=ChemCPAConfig)
    tx_mlp: MLPEncoderConfig = field(
        default_factory=lambda: MLPEncoderConfig(input_dim=TX_INPUT_DIM)
    )
    fusion: str = "transformer_uni_proj"  # | 'transformer' | 'mean' | 'add'
    transformer: FusionConfig = field(default_factory=FusionConfig)
    proj: ProjectorConfig = field(default_factory=ProjectorConfig)
    pos_emb_type: str = "learnable"  # | 'sinusoidal'
    pos_emb_dropout: float = 0.2
    normalize: bool = False
    adapt_before_fusion: bool = False
    use_tx_basal: bool = False
    # run the fusion transformer over drug-axis chunks of this size (each
    # drug's ~21-token sequence is independent, so this is EXACT): bounds
    # the 2048-latent activation footprint for full-batch training at
    # reference scale. None = whole batch at once.
    fusion_batch_chunk: Optional[int] = None
    num_modalities: int = NUM_MODALITIES
    num_non_tx_modalities: int = NUM_NON_TX_MODALITIES

    @property
    def num_tx_bottlenecks(self) -> int:
        return self.transformer.num_tx_bottlenecks

    @property
    def seq_len(self) -> int:
        """Fusion transformer sequence length (tokens)."""
        n = self.num_modalities + self.transformer.num_tx_bottlenecks
        if self.transformer.agg == "cls":
            n += 1
        return n

    @property
    def pos_emb_max_len(self) -> int:
        """Reference: models.py:668-676 -- pos-enc covers non-tx (+CLS) tokens
        when bottlenecks are used, otherwise all modality tokens."""
        n = (
            self.num_non_tx_modalities
            if self.transformer.num_tx_bottlenecks > 0
            else self.num_modalities
        )
        if self.transformer.agg == "cls":
            n += 1
        return n


@dataclass(frozen=True)
class ModelConfig:
    """Encoder + bilinear multilabel decoder (NovelDDIMultilabel analog).

    Reference: madrigal/models/models.py:914-953.
    """
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    prediction_dim: int = 1  # number of DDI outcome labels
    prediction_dim_single_drug: Optional[int] = None
    decoder_normalize: bool = False
    use_single_drug: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    """Multi-LR optimizer groups. Reference: parse_args.py:123-135, utils.py:463-613."""
    optimizer: str = "adamw"  # 'adamw' | 'radam' | 'lars'
    structure_encoder_lr: float = 1e-4
    kg_encoder_lr: float = 1e-4
    perturb_encoders_lr: float = 1e-4
    fusion_lr: float = 1e-4
    decoder_lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 1e-2
    momentum: float = 0.9  # SGD/LARS


@dataclass(frozen=True)
class TrainConfig:
    """DDI finetune stage. Reference: parse_args.py:114-171."""
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    data_source: str = "TWOSIDES"
    split_method: str = "split_by_triplets"
    repeat: Optional[str] = None
    loss_fn_name: str = "bce"
    task: str = "multilabel"
    num_epochs: int = 600
    batch_size: Optional[int] = None  # None => full batch
    num_negative_samples_per_pair: Optional[int] = None
    negative_sampling_probs_type: str = "uniform"
    loss_readout: str = "mean"
    finetune_mode: str = "str_random_sample"
    checkpoint: Optional[str] = None
    frozen: bool = False
    train_with_str_str: bool = False
    adapt_before_fusion: bool = False
    use_pretrained_adaptor: bool = False
    evaluate_interval: int = 10
    warmup_epochs: int = 50
    seed: int = 42
    test: bool = True
    use_drugbank: bool = False
    use_single_drug: bool = False
    loss_ratio_single_drug: float = 10.0
    dataset_ratio: str = "1_1_1"
    save_dir: Optional[str] = None
    # rematerialize each forward inside the (up to 3-forward) loss so the
    # backward pass holds one forward's activations at a time -- the
    # TPU-memory knob for full-batch training at reference scale (trades
    # ~1 extra forward's FLOPs per forward for ~3x lower activation peak)
    remat_forwards: bool = False
    # label-chunked (ELL) triple layout for the training loss: the static
    # full-batch triple list is label-sorted once with each label's run
    # padded to a multiple of this, so the decoder gathers each [D, D]
    # weight slice once per chunk instead of once per triple (and its
    # backward scatter-add shrinks by the same factor -- the dominant
    # full-batch step cost on TPU). 0 = per-triple gathers. Numerics
    # identical; the eval-facing triple order is unchanged.
    label_chunk_triples: int = 0
    # three-way-loss modes only: run each of the (up to 3) forwards as its
    # own jitted value_and_grad and accumulate gradients, instead of one
    # monolithic 3-forward step. Gradient-of-sum == sum-of-gradients, so
    # numerics match the fused step; peak activation memory AND compiler
    # working-set shrink to one forward's (the fused 3-forward program at
    # reference scale can OOM the XLA *compiler*).
    split_forward_grads: bool = False
    # split_forward_grads multi-forward modes: compute the full-KG drug
    # table ONCE per epoch and pass it into each per-forward grad program
    # as an argument, accumulating the table cotangents across forwards
    # and running a single KG backward at the end -- instead of paying the
    # (mask-independent, rng-free) KG fwd+bwd inside every forward. The
    # fused step gets this for free from XLA CSE; this restores it for the
    # split path. KG cost per epoch: 3x(fwd+bwd) -> 2xfwd + 1xbwd.
    # Numerics identical (the KG path has no dropout/batch_stats).
    split_share_kg_table: bool = True


@dataclass(frozen=True)
class PretrainConfig:
    """Contrastive (SimCLR) pretrain stage. Reference: parse_args.py:173-213."""
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    data_source: str = "TWOSIDES"
    split_method: str = "split_by_drugs_random"
    pretrain_loss_func: str = "infonce"
    pretrain_mode: str = "str_center_uni"
    pretrain_unbalanced: bool = False
    pretrain_tx_downsample_ratio: float = 1.0
    pretrain_num_epochs: int = 5000
    pretrain_batch_size: int = 1000
    pretrain_lr: float = 1e-4
    pretrain_wd: float = 1e-2
    pretrain_eps: float = 1e-8
    pretrain_beta1: float = 0.9
    pretrain_beta2: float = 0.999
    pretrain_momentum: float = 0.9
    pretrain_optimizer: str = "adamw"
    warmup_epochs: int = 50
    moco_mlp_dim: int = 512
    moco_t: float = 0.1
    shared_predictor: bool = False
    raw_encoder_output: bool = False
    too_hard_neg_mask: bool = False
    str_sim_threshold: float = 0.95
    kg_sim_threshold: float = 0.95
    perturb_sim_threshold: float = 0.95
    save_checkpoints: int = 100
    seed: int = 42
    resume: str = ""
    save_dir: Optional[str] = None


# ---------------------------------------------------------------------------
# (De)serialization: configs <-> plain dicts (for YAML override + checkpoints)
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _resolve_field_type(f: dataclasses.Field):
    """Field types are strings under `from __future__ import annotations`;
    resolve dataclass names against this module."""
    t = f.type
    if isinstance(t, str):
        t = globals().get(t, t)
    return t


def from_dict(cls: type, data: dict) -> Any:
    """Rebuild a (possibly nested) dataclass config from a plain dict."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = _resolve_field_type(f)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[f.name] = from_dict(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def override(cfg: Any, overrides: dict) -> Any:
    """Apply a flat-or-nested dict of overrides onto a dataclass config.

    Keys may be dotted paths ('transformer.num_layers') or nested dicts,
    matching the reference's `--from_yaml` layering
    (reference: madrigal/parse_args.py:361-369).
    """
    updates: dict = {}
    for key, value in overrides.items():
        parts = key.split(".")
        node = updates
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def _apply(c, upd):
        if not dataclasses.is_dataclass(c):
            return upd
        kwargs = {}
        for f in dataclasses.fields(c):
            if f.name in upd:
                v = upd[f.name]
                cur = getattr(c, f.name)
                if isinstance(v, dict) and dataclasses.is_dataclass(cur):
                    kwargs[f.name] = _apply(cur, v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
        return dataclasses.replace(c, **kwargs)

    return _apply(cfg, updates)


def load_yaml_overrides(cfg: Any, path: str | Path) -> Any:
    import yaml

    data = yaml.safe_load(Path(path).read_text())
    return override(cfg, data or {})


def dumps(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def validate(cfg: Any) -> None:
    """Derived-arg consistency checks (reference: parse_args.py:372-433)."""
    if isinstance(cfg, TrainConfig):
        if cfg.data_source == "DrugBank":
            assert cfg.task == "multiclass", "DrugBank uses multiclass task"
        elif cfg.data_source == "TWOSIDES":
            assert cfg.task == "multilabel", "TWOSIDES uses multilabel task"
        assert cfg.finetune_mode in FINETUNE_MODES, cfg.finetune_mode
        lc = cfg.label_chunk_triples
        if lc:
            # The chunk-scanned decoder reshapes [TRIPLE_CHUNK]-sized scan
            # chunks into [C/lc, lc]; a non-divisor would silently need
            # ragged chunks. Fail here with a usable message instead of an
            # AssertionError deep inside the jit trace.
            from .models.decoder import BilinearDDIScorer

            c = BilinearDDIScorer.TRIPLE_CHUNK
            if lc < 0 or c % lc:
                raise ValueError(
                    f"label_chunk_triples={lc} must be a positive divisor "
                    f"of the decoder scan chunk {c} (a power of two "
                    f"<= {c}, e.g. 32/64/128), or 0 to disable")
        rp = cfg.model.encoder.transformer.remat_policy
        if rp not in (None, "dots", "all"):
            raise ValueError(
                f"transformer.remat_policy={rp!r} (None | 'dots' | 'all')")
    if isinstance(cfg, PretrainConfig):
        assert cfg.pretrain_mode in PRETRAIN_MODES, cfg.pretrain_mode
