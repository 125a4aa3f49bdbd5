"""Subpackage of the PyTorch port; mirrors `madrigal_tpu.utils`."""
