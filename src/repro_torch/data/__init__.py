"""Data pipeline with predicate-plan record selection as a first-class stage."""
from .pipeline import (CorpusMetadata, PredicateFilteredDataset,
                       default_quality_filter, make_corpus_metadata)

__all__ = ["CorpusMetadata", "PredicateFilteredDataset",
           "make_corpus_metadata", "default_quality_filter"]
