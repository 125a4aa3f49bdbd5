"""Madrigal-TPU in PyTorch: the port of `madrigal_tpu` to PyTorch and CUDA.

Module paths mirror the JAX package's (`madrigal_tpu_torch/models/hgt.py`
<-> `madrigal_tpu/models/hgt.py`). The package imports torch and numpy,
never JAX and nothing of `madrigal_tpu`. Entry points run on `cuda`
unless the caller asks for the CPU (`device="cpu"`, `--platform cpu`).

Serving: checkpoint -> full-KG HGT pass -> per-drug encode -> all-pairs
scores through the hand-written bilinear kernel (`csrc/bilinear.cu`) ->
triple queries, normalized ranks and ensembles. Stage-3 training
(`cli/train_ddi.py`), on synthetic or reference-format data
(`data/datasets.py`), from a fresh start or a stage-2 warm start:
per-epoch masks -> one KG pass -> the loss forwards -> the HGT backward
through the hand-written sorted segment-sum kernel (`csrc/segment_sum.cu`)
-> multi-LR AdamW, RAdam or LARS, with the evaluation sweep.
"""

__version__ = "0.1.0"
