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

    The float32 matmul precision is left as the caller set it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or "
                "--platform cpu) to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def copy_to_host(dst, src: torch.Tensor) -> None:
    """Copy `src` into the host array `dst` (an ndarray or a slice of an
    np.memmap, of `src`'s shape and dtype) in one transfer, with no host
    tensor in between."""
    torch.from_numpy(dst).copy_(src)
