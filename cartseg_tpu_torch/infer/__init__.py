"""Inference and the self-training toolchain: batched ensemble
inference with on-device QC gates (create_pseudo_labels[_gpu].py),
hard-case mining (mine_hard_cases.py) and soft-prob ranking
(get_best_pseudo_masks.py)."""

from cartseg_tpu_torch.infer.engine import (
    EnsembleMember, load_member, ensemble_probs_fn, qc_stats_fn,
    pseudo_label_program,
)
from cartseg_tpu_torch.infer.pseudo_labels import (
    PseudoLabelConfig, QCThresholds, generate_pseudo_labels, should_accept,
)
from cartseg_tpu_torch.infer.mining import MiningConfig, mine_hard_cases
from cartseg_tpu_torch.infer.ranking import (RankingConfig,
                                             rank_pseudo_masks, score_sample)

__all__ = [
    "EnsembleMember", "load_member", "ensemble_probs_fn", "qc_stats_fn",
    "pseudo_label_program",
    "PseudoLabelConfig", "QCThresholds", "generate_pseudo_labels",
    "should_accept",
    "MiningConfig", "mine_hard_cases",
    "RankingConfig", "rank_pseudo_masks", "score_sample",
]
