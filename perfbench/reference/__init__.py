"""The plain reference: predicate trees evaluated record by record with
plain PyTorch comparisons over the harness's own data, packed as the
program packs its answers, and the comparison that decides ``correct``."""
from .evaluate import Reference, compare_answer, pack_words

__all__ = ["Reference", "compare_answer", "pack_words"]
