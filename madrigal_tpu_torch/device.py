"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without
a card and without that request they raise: they never fall back to the
CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means `cuda`. Raises if CUDA is asked for and absent.

    On CUDA it also turns TF32 off for float32 matmuls and convolutions,
    so float32 work stays in full float32 as on the JAX reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or "
                "--platform cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def copy_to_host(dst, src: torch.Tensor) -> None:
    """Copy `src` into the host array `dst` (an ndarray or a slice of an
    np.memmap, of `src`'s shape and dtype) in one transfer, with no host
    tensor in between."""
    torch.from_numpy(dst).copy_(src)
