"""Global constants for the Madrigal-TPU framework.

Mirrors the reference's global constant surface (reference: madrigal/utils.py:25-45):
SEED, MOL_DIM, MAX_DRUGS, the ordered LINCS cell-line list, and the
environment-overridable non-transcriptomics modality list.
"""
from __future__ import annotations

import os

SEED = 42

# torchdrug-compatible default molecular featurization dims
# (reference: madrigal/utils.py:26, madrigal/parse_args.py:24,32)
MOL_DIM = 67  # atom feature dim
BOND_DIM = 18  # bond feature dim

MAX_DRUGS = 25_000

# Ordered LINCS cell lines (reference: madrigal/utils.py:28)
CELL_LINES = [
    "a375", "a549", "asc", "ha1e", "hcc515", "hec108", "hela", "hepg2",
    "ht29", "huvec", "mcf7", "npc", "pc3", "thp1", "vcap", "yapc",
]
CELL_LINES_CAPITALIZED = [c.upper() for c in CELL_LINES]
NUM_CELL_LINES = len(CELL_LINES)

# Non-transcriptomics modalities, overridable via env var ("str_kg_cv_bs")
# (reference: madrigal/utils.py:30-37)
_non_tx_env = os.getenv("NON_TX_MODALITIES")
if _non_tx_env:
    NON_TX_MODALITIES = _non_tx_env.split("_")
else:
    NON_TX_MODALITIES = ["str", "kg", "cv"]
NUM_NON_TX_MODALITIES = len(NON_TX_MODALITIES)
NUM_MODALITIES = NUM_NON_TX_MODALITIES + NUM_CELL_LINES

# Transcriptomics signature dim (L1000 landmark genes)
# (reference: madrigal/models/models.py:30)
TX_INPUT_DIM = 978

# Cell-viability signature dim (reference: modality_pretraining/cv/cv_pretraining.py:59)
CV_INPUT_DIM = 559

# Default embedding dim (reference: madrigal/parse_args.py:16)
FEATURE_DIM = 128
