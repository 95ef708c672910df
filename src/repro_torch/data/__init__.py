"""Synthetic math tasks and the byte-level tokenizer (copy of the
reference's ``repro.data.tasks``: the same seed gives the same tasks)."""
