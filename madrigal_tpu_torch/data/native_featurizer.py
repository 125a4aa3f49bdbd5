"""ctypes binding to the native C++ SMILES featurizer (port of
`madrigal_tpu/data/native_featurizer.py`).

The source is the repository's `native/featurizer.cpp` (its C ABI: the
two `extern "C"` blocks). At first use it is compiled with g++ into
`build/native/libmadrigal_native.so` beside the checkout, and rebuilt
when the source is newer than the library; nothing is written under
`native/`. A failed compile raises: there is no fallback to the Python
parser. The native path featurizes SMILES batches without the Python
parser's overhead, the bulk host data path for large drug tables.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..constants import BOND_DIM, MOL_DIM
from ..device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_PATH = os.path.join(_REPO, "native", "featurizer.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_SO_PATH = os.path.join(_BUILD_DIR, "libmadrigal_native.so")

_lib = None

_f32 = C.POINTER(C.c_float)
_i32 = C.POINTER(C.c_int32)
_u8 = C.POINTER(C.c_uint8)


def build_native(force: bool = False) -> str:
    """Compile the shared library if it is missing or older than the
    source (the JAX package's g++ flags); returns its path. The library
    is written to a temporary name and renamed, so that processes that
    build at once never load a half-written file."""
    if (not force and os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC_PATH)):
        return _SO_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
             _SRC_PATH], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ could not build {_SRC_PATH}:\n{res.stderr[-3000:]}")
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(build_native())
    lib.mtpu_featurize.restype = C.c_int
    lib.mtpu_featurize.argtypes = [
        C.c_char_p, _f32, _i32, _i32, _f32, _i32, C.c_int32, C.c_int32]
    lib.mtpu_featurize_batch.restype = C.c_int
    lib.mtpu_featurize_batch.argtypes = [
        C.c_char_p, _i32, C.c_int32, _f32, _i32, _i32, _f32, _i32,
        C.c_int32, C.c_int32]
    lib.mtpu_featurize_pack.restype = C.c_int
    lib.mtpu_featurize_pack.argtypes = [
        C.c_char_p, _i32, C.c_int32, _f32, _u8, _i32, _i32, _i32, _f32,
        _u8, C.c_int32, C.c_int32, _i32, _i32]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(C.POINTER(ctype))


def _pack_strings(smiles_list: List[str]):
    """(NUL-separated buffer, int32 start offsets) of a SMILES list."""
    offsets = np.zeros(len(smiles_list), np.int32)
    buf = bytearray()
    for i, s in enumerate(smiles_list):
        offsets[i] = len(buf)
        buf += s.encode() + b"\0"
    return bytes(buf), offsets


def featurize_smiles_native(smiles: str, node_cap: int = 256,
                            edge_cap: int = 512) -> Optional[dict]:
    """One SMILES -> molgraph dict, or None when it does not parse (or
    outgrows the caps)."""
    lib = _load()
    node_feats = np.zeros((node_cap, MOL_DIM), np.float32)
    edge_index = np.zeros((edge_cap, 2), np.int32)
    edge_feats = np.zeros((edge_cap, BOND_DIM), np.float32)
    na = C.c_int32(0)
    ne = C.c_int32(0)
    rc = lib.mtpu_featurize(
        smiles.encode(), _ptr(node_feats, C.c_float), C.byref(na),
        _ptr(edge_index, C.c_int32), _ptr(edge_feats, C.c_float),
        C.byref(ne), node_cap, edge_cap)
    if rc != 0:
        return None
    n, e = na.value, ne.value
    return {"node_feats": node_feats[:n].copy(),
            "edge_index": edge_index[:e].copy(),
            "edge_feats": edge_feats[:e].copy()}


def featurize_batch_native(smiles_list: List[str], node_cap: int = 256,
                           edge_cap: int = 512) -> List[Optional[dict]]:
    """Bulk featurization in one native call; None where a SMILES does
    not parse."""
    lib = _load()
    count = len(smiles_list)
    buf, offsets = _pack_strings(smiles_list)
    node_feats = np.zeros((count, node_cap, MOL_DIM), np.float32)
    edge_index = np.zeros((count, edge_cap, 2), np.int32)
    edge_feats = np.zeros((count, edge_cap, BOND_DIM), np.float32)
    n_atoms = np.zeros(count, np.int32)
    n_edges = np.zeros(count, np.int32)
    lib.mtpu_featurize_batch(
        buf, _ptr(offsets, C.c_int32), count, _ptr(node_feats, C.c_float),
        _ptr(n_atoms, C.c_int32), _ptr(edge_index, C.c_int32),
        _ptr(edge_feats, C.c_float), _ptr(n_edges, C.c_int32),
        node_cap, edge_cap)
    out: List[Optional[dict]] = []
    for m in range(count):
        if n_atoms[m] == 0:
            out.append(None)
            continue
        n, e = int(n_atoms[m]), int(n_edges[m])
        out.append({"node_feats": node_feats[m, :n].copy(),
                    "edge_index": edge_index[m, :e].copy(),
                    "edge_feats": edge_feats[m, :e].copy()})
    return out


def featurize_pack_native(smiles_list: List[str],
                          node_budget: Optional[int] = None,
                          edge_budget: Optional[int] = None,
                          pad_multiple: int = 128,
                          device: torch.device | str | None = None):
    """Featurize and pack a SMILES batch into one padded arena in a single
    native call: the port's MolGraphBatch on `device` (None: the card).
    A SMILES that does not parse becomes a one-atom dummy graph, so graph
    ids stay aligned with the input."""
    from .molgraph import MolGraphBatch, round_up

    device = resolve_device(device)
    lib = _load()
    count = len(smiles_list)
    buf, offsets = _pack_strings(smiles_list)
    # conservative default budgets: far above real molecules' atoms and
    # bonds per SMILES character; callers pass budgets for tight fits
    nb = node_budget or round_up(max(sum(len(s) for s in smiles_list), 16),
                                 pad_multiple)
    eb = edge_budget or round_up(nb * 4, pad_multiple)

    node_feats = np.zeros((nb, MOL_DIM), np.float32)
    node_mask = np.zeros(nb, np.uint8)
    node_graph = np.zeros(nb, np.int32)
    edge_src = np.zeros(eb, np.int32)
    edge_dst = np.zeros(eb, np.int32)
    edge_feats = np.zeros((eb, BOND_DIM), np.float32)
    edge_mask = np.zeros(eb, np.uint8)
    nn_ = C.c_int32(0)
    ne = C.c_int32(0)
    rc = lib.mtpu_featurize_pack(
        buf, _ptr(offsets, C.c_int32), count, _ptr(node_feats, C.c_float),
        _ptr(node_mask, C.c_uint8), _ptr(node_graph, C.c_int32),
        _ptr(edge_src, C.c_int32), _ptr(edge_dst, C.c_int32),
        _ptr(edge_feats, C.c_float), _ptr(edge_mask, C.c_uint8),
        nb, eb, C.byref(nn_), C.byref(ne))
    if rc != 0:
        raise ValueError(f"arena budgets too small (rc={rc}): "
                         f"nodes {nb}, edges {eb}")

    def t(x):
        return torch.from_numpy(x).to(device)

    return MolGraphBatch(
        node_feats=t(node_feats), node_mask=t(node_mask.astype(bool)),
        node_graph=t(node_graph), edge_src=t(edge_src),
        edge_dst=t(edge_dst), edge_feats=t(edge_feats),
        edge_mask=t(edge_mask.astype(bool)), num_graphs=count)
