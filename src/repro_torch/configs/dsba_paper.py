"""The paper's own experiment configurations (Section 7).

N=10 nodes, Erdos-Renyi(0.4) topology, Laplacian-based constant edge weight
mixing, lambda = 1/(10 Q), rows normalized to ||a|| = 1. Dataset presets
mirror News20/RCV1/Sector statistics (synthetic — see data/synthetic.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    task: str  # ridge | logistic | auc
    dataset: str  # preset name in data/synthetic.DATASET_PRESETS
    n_nodes: int = 10
    q: int = 100
    er_p: float = 0.4
    alpha: float = 0.5
    seed: int = 0


EXPERIMENTS = {
    "ridge_rcv1": PaperExperiment("ridge", "rcv1", alpha=0.5),
    "ridge_sector": PaperExperiment("ridge", "sector", alpha=0.5),
    "logistic_rcv1": PaperExperiment("logistic", "rcv1", alpha=4.0),
    "logistic_news20": PaperExperiment("logistic", "news20", alpha=4.0),
    "auc_rcv1": PaperExperiment("auc", "rcv1", alpha=1.0),
    "auc_sector": PaperExperiment("auc", "sector", alpha=1.0),
    # small variants for quick runs / CI
    "ridge_small": PaperExperiment("ridge", "small", q=50, alpha=0.5),
    "logistic_small": PaperExperiment("logistic", "small", q=50, alpha=4.0),
    "auc_small": PaperExperiment("auc", "small", q=50, alpha=1.0),
}
