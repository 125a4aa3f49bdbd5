"""Madrigal-TPU in PyTorch: the port of `madrigal_tpu` to PyTorch and CUDA.

Module paths mirror the JAX package's (`madrigal_tpu_torch/models/hgt.py`
<-> `madrigal_tpu/models/hgt.py`). The package imports torch and numpy,
never JAX and nothing of `madrigal_tpu`. Entry points run on `cuda`
unless the caller asks for the CPU (`device="cpu"`, `--platform cpu`).

Two paths are ported. Serving: checkpoint -> full-KG HGT pass ->
per-drug encode -> all-pairs scores through the hand-written bilinear
kernel (`csrc/bilinear.cu`) -> triple queries. Stage-3 training
(`cli/train_ddi.py`): per-epoch masks -> one KG pass -> the loss
forwards -> the HGT backward through the hand-written sorted segment-sum
kernel (`csrc/segment_sum.cu`) -> multi-LR AdamW.
"""

__version__ = "0.1.0"
