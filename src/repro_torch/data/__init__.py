"""Synthetic math tasks, the byte-level tokenizer and greedy sequence
packing (copies of the reference's ``repro.data.tasks`` and
``repro.data.packing``: the same seed gives the same tasks)."""
from .tasks import MathTaskGenerator, Tokenizer
from .packing import greedy_pack

__all__ = ["MathTaskGenerator", "Tokenizer", "greedy_pack"]
