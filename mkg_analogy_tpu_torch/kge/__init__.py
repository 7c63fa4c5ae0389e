"""The KGE silos (IKRL/TransAE and RSME), ported from
``mkg_analogy_tpu/kge/``."""

from .scorers import (
    transe_distance,
    analogy_energy,
    complex_score,
    complex_queries,
)
from .sampling import TripleStore, NegativeSampler

__all__ = [
    "transe_distance",
    "analogy_energy",
    "complex_score",
    "complex_queries",
    "TripleStore",
    "NegativeSampler",
]
