"""SMILES -> graph featurization, torchdrug-compatible layout (a copy of
`madrigal_tpu/data/featurize.py`, which imports no JAX; its `native`
backend is the port's own binding, `data/native_featurizer.py`).

Produces the 67-dim atom / 18-dim bond features the reference's structure
encoder consumes (reference: madrigal/utils.py:26 MOL_DIM=67,
parse_args.py:32 edge dim 18 -- torchdrug 'default' atom/bond features).

Backends:
  * RDKit when importable (exact torchdrug semantics; RDKit is CPU-side
    C++ featurization, not device math -- SURVEY.md section 2.1).
  * Built-in pure-Python parser (data/smiles.py) otherwise; hybridization /
    conjugation / aromatic-H counting are approximations documented there.
  * An optional C++ fast path (native/) drop-in replaces the Python parser
    for bulk featurization.

Feature layout (concatenation order fixed):
  atoms: symbol onehot(17+unk) | chiral(4) | total-degree(7+unk) |
         formal charge(-5..5 -> 11) | total numH(7+unk) | radicals(8) |
         hybridization(8) | [aromatic, in_ring]            => 67
  bonds: type onehot(4: single/double/triple/aromatic) | dir(7) |
         stereo(6) | [conjugated]                          => 18
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..constants import BOND_DIM, MOL_DIM

ATOM_VOCAB = ["H", "B", "C", "N", "O", "F", "Mg", "Si", "P", "S", "Cl",
              "Cu", "Zn", "Se", "Br", "Sn", "I"]
ATOM_INDEX = {s: i for i, s in enumerate(ATOM_VOCAB)}


def _onehot(idx: int, size: int, allow_unknown: bool = False) -> np.ndarray:
    width = size + (1 if allow_unknown else 0)
    v = np.zeros(width, dtype=np.float32)
    if 0 <= idx < size:
        v[idx] = 1.0
    elif allow_unknown:
        v[size] = 1.0
    else:
        raise ValueError(f"index {idx} outside vocab of size {size}")
    return v


def atom_feature(symbol: str, chiral: int, total_degree: int,
                 formal_charge: int, num_h: int, num_radical: int,
                 hybridization: int, aromatic: bool, in_ring: bool
                 ) -> np.ndarray:
    parts = [
        _onehot(ATOM_INDEX.get(symbol, -1), len(ATOM_VOCAB), True),
        _onehot(chiral, 4),
        _onehot(total_degree, 7, True),
        _onehot(formal_charge + 5, 11) if -5 <= formal_charge <= 5
        else _onehot(-1, 11) * 0,
        _onehot(num_h, 7, True),
        _onehot(min(num_radical, 7), 8),
        _onehot(hybridization, 8),
        np.asarray([float(aromatic), float(in_ring)], np.float32),
    ]
    out = np.concatenate(parts)
    assert out.shape[0] == MOL_DIM, out.shape
    return out


def bond_feature(order: int, aromatic: bool, direction: int, stereo: int,
                 conjugated: bool) -> np.ndarray:
    if aromatic:
        type_idx = 3
    else:
        type_idx = {1: 0, 2: 1, 3: 2}.get(order, 0)
    parts = [
        _onehot(type_idx, 4),
        _onehot(direction, 7),
        _onehot(stereo, 6),
        np.asarray([float(conjugated)], np.float32),
    ]
    out = np.concatenate(parts)
    assert out.shape[0] == BOND_DIM, out.shape
    return out


def _rdkit_available() -> bool:
    try:
        import rdkit  # noqa: F401

        return True
    except ImportError:
        return False


def featurize_smiles_rdkit(smiles: str) -> Optional[dict]:
    from rdkit import Chem

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    n = mol.GetNumAtoms()
    node_feats = np.zeros((n, MOL_DIM), np.float32)
    for i, atom in enumerate(mol.GetAtoms()):
        node_feats[i] = atom_feature(
            atom.GetSymbol(), int(atom.GetChiralTag()),
            atom.GetTotalDegree(), atom.GetFormalCharge(),
            atom.GetTotalNumHs(), atom.GetNumRadicalElectrons(),
            int(atom.GetHybridization()), atom.GetIsAromatic(),
            atom.IsInRing(),
        )
    edges, feats = [], []
    for bond in mol.GetBonds():
        a, b = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        bt = bond.GetBondType()
        order = {Chem.BondType.SINGLE: 1, Chem.BondType.DOUBLE: 2,
                 Chem.BondType.TRIPLE: 3}.get(bt, 1)
        f = bond_feature(order, bt == Chem.BondType.AROMATIC,
                         int(bond.GetBondDir()), int(bond.GetStereo()),
                         bond.GetIsConjugated())
        edges += [(a, b), (b, a)]
        feats += [f, f]
    return _pack(node_feats, edges, feats)


def featurize_smiles_builtin(smiles: str) -> Optional[dict]:
    from .smiles import SmilesError, hybridization_of, parse_smiles

    try:
        mol = parse_smiles(smiles)
    except (SmilesError, ValueError, IndexError):
        return None
    n = mol.num_atoms
    node_feats = np.zeros((n, MOL_DIM), np.float32)
    for i, atom in enumerate(mol.atoms):
        node_feats[i] = atom_feature(
            atom.symbol, min(atom.chiral, 3),
            atom.degree + atom.n_h, atom.charge, atom.n_h, 0,
            hybridization_of(atom, mol.bonds), atom.aromatic, atom.in_ring,
        )
    edges, feats = [], []
    for bond in mol.bonds:
        f = bond_feature(bond.order, bond.aromatic, bond.direction, 0,
                         bond.conjugated)
        edges += [(bond.a, bond.b), (bond.b, bond.a)]
        feats += [f, f]
    return _pack(node_feats, edges, feats)


def _pack(node_feats, edges, feats) -> dict:
    e = len(edges)
    return {
        "node_feats": np.asarray(node_feats, np.float32),
        "edge_index": np.asarray(edges, np.int32).reshape(e, 2),
        "edge_feats": np.asarray(feats, np.float32).reshape(e, BOND_DIM),
    }


def featurize_smiles(smiles: str, backend: Optional[str] = None
                     ) -> Optional[dict]:
    """SMILES -> molgraph dict ({node_feats, edge_index, edge_feats}),
    or None for unparseable input."""
    if backend is None:
        backend = "rdkit" if _rdkit_available() else "builtin"
    if backend == "rdkit":
        return featurize_smiles_rdkit(smiles)
    if backend == "builtin":
        return featurize_smiles_builtin(smiles)
    if backend == "native":
        from .native_featurizer import featurize_smiles_native

        return featurize_smiles_native(smiles)
    raise ValueError(backend)


def featurize_many(smiles_list: List[str], backend: Optional[str] = None
                   ) -> List[Optional[dict]]:
    return [featurize_smiles(s, backend) for s in smiles_list]
