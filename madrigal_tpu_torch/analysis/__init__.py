"""Downstream analysis layer (port of `madrigal_tpu/analysis/`, the same
exports): the computational core of the reference's fig1-6 / discussion
notebooks, as a tested library.

The reference's notebooks (reference: notebooks/fig3/fig3_self_combo.ipynb,
fig4/fig4_clinical_trials_combos.ipynb, fig5/fig5_t2d_mash.ipynb, ...)
mix paper-specific external datasets (DILIrank, CDCDB clinical trials,
OpenTargets) with a reusable set of tensor queries and statistics over
the [L, N, N] score/normalized-rank artifacts. The external data wrangling
is irreproducible here (private paths); the query/statistics layer is
what a user needs to run the same analyses on their own candidate sets.
"""
from .pretrain_embeds import (  # noqa: F401
    modality_embedding_table,
    per_drug_modality_alignment,
    pretrain_embedding_shift,
    sample_full_modality_drugs,
)
from .profiles import (  # noqa: F401
    binned_similarity_compare,
    combo_class_table,
    ddi_profile_matrix,
    high_similarity_contrast,
    jaccard_similarity,
    load_organ_map,
    match_drug_names,
    organ_class_groups,
)
from .ddi_queries import (  # noqa: F401
    aggregate_outcomes,
    cv_validation_auroc,
    external_validation,
    load_outcome_mapper,
    map_outcome_labels,
    pair_values,
    rank_enrichment,
    self_combo_scores,
    topk_novel_pairs,
)
