"""Minimal SMILES parser (a copy of `madrigal_tpu/data/smiles.py`, which
imports no JAX; the port keeps its own), the host-side featurization
fallback.

The reference featurizes molecules through torchdrug/RDKit (C++)
(reference: madrigal/data/data.py:10 `PackedMolecule`, models.py:720).
RDKit is used when installed (data/featurize.py); this module provides a
dependency-free fallback parser covering the organic subset + brackets,
rings (incl. %nn), branches, charges, aromatic atoms/bonds, and computes
implicit hydrogens by standard valences. Stereo annotations (@, @@, /, \\)
are parsed and recorded but not geometrically interpreted.

Output: Molecule with per-atom (symbol, charge, n_h, aromatic, in_ring,
degree, hybridization, chiral) and per-bond (order, aromatic, conjugated,
in_ring) attributes -- everything the 67/18-dim featurization needs.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as"}

# standard valences used for implicit-H computation (RDKit default set)
DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
    "H": (1,),
}


@dataclasses.dataclass
class Atom:
    symbol: str
    aromatic: bool = False
    charge: int = 0
    explicit_h: Optional[int] = None  # from brackets
    isotope: Optional[int] = None
    chiral: int = 0  # 0 none, 1 @, 2 @@
    idx: int = 0
    in_ring: bool = False
    n_h: int = 0  # total H (set post-parse)
    bonds: List[int] = dataclasses.field(default_factory=list)

    @property
    def degree(self) -> int:
        return len(self.bonds)


@dataclasses.dataclass
class Bond:
    a: int
    b: int
    order: int = 1  # 1/2/3; aromatic bonds get order 1 + aromatic flag
    aromatic: bool = False
    in_ring: bool = False
    conjugated: bool = False
    direction: int = 0  # 0 none, 1 '/', 2 '\\'


@dataclasses.dataclass
class Molecule:
    atoms: List[Atom]
    bonds: List[Bond]

    @property
    def num_atoms(self):
        return len(self.atoms)


_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2})?(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?(?::(?P<map>\d+))?$"
)


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str) -> Molecule:
    atoms: List[Atom] = []
    bonds: List[Bond] = []
    stack: List[int] = []
    prev: Optional[int] = None
    pending_order = 0  # 0 = default single/aromatic
    pending_dir = 0
    ring_openings: Dict[str, Tuple[int, int, int]] = {}

    i = 0
    n = len(smiles)

    def add_atom(a: Atom) -> int:
        a.idx = len(atoms)
        atoms.append(a)
        return a.idx

    def add_bond(x: int, y: int, order: int, direction: int):
        ar = atoms[x].aromatic and atoms[y].aromatic and order == 0
        b = Bond(a=x, b=y, order=(order if order > 0 else 1), aromatic=ar,
                 direction=direction)
        bonds.append(b)
        atoms[x].bonds.append(len(bonds) - 1)
        atoms[y].bonds.append(len(bonds) - 1)

    while i < n:
        ch = smiles[i]
        if ch == "(":
            if prev is None:
                raise SmilesError("branch before any atom")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unbalanced parentheses")
            prev = stack.pop()
            i += 1
        elif ch in "-=#:$":
            pending_order = {"-": 1, "=": 2, "#": 3, ":": 0, "$": 4}[ch]
            i += 1
        elif ch in "/\\":
            pending_dir = 1 if ch == "/" else 2
            pending_order = 1
            i += 1
        elif ch == ".":
            prev = None
            pending_order = 0
            i += 1
        elif ch == "[":
            j = smiles.index("]", i)
            body = smiles[i + 1 : j]
            m = _BRACKET_RE.match(body)
            if not m:
                raise SmilesError(f"bad bracket atom [{body}]")
            sym = m.group("symbol")
            aromatic = sym[0].islower() and sym != "*"
            symbol = sym.capitalize() if aromatic else sym
            hc = m.group("hcount")
            if hc is None:
                explicit_h = 0
            elif hc == "H":
                explicit_h = 1
            else:
                explicit_h = int(hc[1:])
            cg = m.group("charge") or ""
            if cg.startswith("+"):
                charge = int(cg[1:]) if cg[1:].isdigit() else len(cg)
            elif cg.startswith("-"):
                charge = -(int(cg[1:]) if cg[1:].isdigit() else len(cg))
            else:
                charge = 0
            a = Atom(symbol=symbol, aromatic=aromatic, charge=charge,
                     explicit_h=explicit_h,
                     isotope=int(m.group("isotope"))
                     if m.group("isotope") else None,
                     chiral=len(m.group("chiral") or ""))
            idx = add_atom(a)
            if prev is not None:
                add_bond(prev, idx, pending_order, pending_dir)
            prev = idx
            pending_order = 0
            pending_dir = 0
            i = j + 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                label = smiles[i + 1 : i + 3]
                i += 3
            else:
                label = ch
                i += 1
            if prev is None:
                raise SmilesError("ring bond before any atom")
            if label in ring_openings:
                other, order0, dir0 = ring_openings.pop(label)
                order = pending_order or order0
                add_bond(prev, other, order, pending_dir or dir0)
                bonds[-1].in_ring = True
            else:
                ring_openings[label] = (prev, pending_order, pending_dir)
            pending_order = 0
            pending_dir = 0
        else:
            # organic subset atom (1- or 2-letter) or aromatic lowercase
            two = smiles[i : i + 2]
            if two in ("Cl", "Br"):
                symbol, aromatic = two, False
                i += 2
            elif ch in "BCNOPSFI":
                symbol, aromatic = ch, False
                i += 1
            elif ch in "bcnops":
                symbol, aromatic = ch.upper(), True
                i += 1
            else:
                raise SmilesError(f"unexpected character {ch!r} at {i}")
            idx = add_atom(Atom(symbol=symbol, aromatic=aromatic))
            if prev is not None:
                add_bond(prev, idx, pending_order, pending_dir)
            prev = idx
            pending_order = 0
            pending_dir = 0

    if ring_openings:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_openings)}")
    if stack:
        raise SmilesError("unbalanced parentheses")

    _finalize(atoms, bonds)
    return Molecule(atoms=atoms, bonds=bonds)


def _finalize(atoms: List[Atom], bonds: List[Bond]):
    # ring membership: any bond in a cycle. Union-find on the graph minus
    # bridges is overkill; use cycle detection via DFS low-links.
    _mark_rings(atoms, bonds)

    for a in atoms:
        if a.explicit_h is not None:
            a.n_h = a.explicit_h
            continue
        bond_order = 0
        for bi in a.bonds:
            b = bonds[bi]
            bond_order += 1 if (b.aromatic or atoms[b.a].aromatic and
                                atoms[b.b].aromatic and b.in_ring and
                                a.aromatic) else b.order
        if a.aromatic:
            # aromatic atom: ring bonds contribute ~1.5; standard treatment:
            # implicit H = valence - (sigma bonds) - (1 if extra pi slot
            # used); use RDKit-like rule: count aromatic degree as
            # round-down of 1.5 per aromatic bond.
            n_arom = sum(1 for bi in a.bonds if bonds[bi].aromatic)
            bond_order = sum(
                bonds[bi].order if not bonds[bi].aromatic else 0
                for bi in a.bonds
            ) + n_arom + (1 if n_arom > 0 else 0)
        valences = DEFAULT_VALENCES.get(a.symbol, (bond_order,))
        eff = bond_order - a.charge if a.symbol in ("N", "P") else bond_order
        eff = bond_order + (-a.charge if a.charge < 0 else 0) if a.symbol in (
            "O", "S") else eff
        if a.symbol in ("N", "P") and a.charge > 0:
            eff = bond_order - a.charge
        h = 0
        for v in valences:
            if eff <= v:
                h = v - eff
                break
        a.n_h = max(h, 0)

    # conjugation: a bond is conjugated if aromatic, or if both its atoms
    # participate in a multiple bond / aromatic system (RDKit-approximate)
    multi = set()
    for b in bonds:
        if b.order >= 2 or b.aromatic:
            multi.add(b.a)
            multi.add(b.b)
    for b in bonds:
        b.conjugated = b.aromatic or (b.a in multi and b.b in multi)


def _mark_rings(atoms: List[Atom], bonds: List[Bond]):
    """An edge is in a ring iff it is not a bridge (Tarjan low-links)."""
    n = len(atoms)
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for bi, b in enumerate(bonds):
        adj[b.a].append((b.b, bi))
        adj[b.b].append((b.a, bi))
    bridges = _find_bridges(n, adj)
    for bi, b in enumerate(bonds):
        b.in_ring = bi not in bridges
        if b.in_ring:
            atoms[b.a].in_ring = True
            atoms[b.b].in_ring = True


def _find_bridges(n, adj):
    visited = [False] * n
    disc = [0] * n
    low = [0] * n
    timer = [1]
    bridges = set()

    for root in range(n):
        if visited[root]:
            continue
        stack = [(root, -1, iter(adj[root]))]
        visited[root] = True
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, pb, it = stack[-1]
            advanced = False
            for v, bi in it:
                if bi == pb:
                    continue
                if not visited[v]:
                    visited[v] = True
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, bi, iter(adj[v])))
                    advanced = True
                    break
                else:
                    low[u] = min(low[u], disc[v])
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        bridges.add(pb)
    return bridges


def hybridization_of(atom: Atom, bonds: List[Bond]) -> int:
    """RDKit-approximate hybridization index in the 8-value vocabulary
    (UNSPECIFIED=0, S=1, SP=2, SP2=3, SP3=4, SP3D=5, SP3D2=6, OTHER=7)."""
    if atom.aromatic:
        return 3
    orders = [bonds[bi].order for bi in atom.bonds]
    n_double = sum(1 for o in orders if o == 2)
    n_triple = sum(1 for o in orders if o == 3)
    heavy = atom.degree
    total = heavy + atom.n_h
    if n_triple or n_double >= 2:
        return 2  # SP
    if n_double == 1:
        return 3  # SP2
    if total <= 1 and heavy == 0:
        return 1  # S (bare atom/ion)
    if total >= 6:
        return 6
    if total == 5:
        return 5
    return 4  # SP3
