from .readers import MarKG, MARS, AnalogyExample
from .vocab import KGVocab

__all__ = ["MarKG", "MARS", "AnalogyExample", "KGVocab"]
