"""DLMC-style synthetic matrix corpus (see ``generators``)."""
from repro_torch.corpus.generators import (CorpusSpec, FAMILIES,
                                           default_corpus, make_dense,
                                           make_matrix)

__all__ = ["CorpusSpec", "FAMILIES", "default_corpus", "make_dense",
           "make_matrix"]
