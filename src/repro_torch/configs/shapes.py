"""Assigned input shapes (per-arch shape set for LM transformers).

  train_4k    — training step,      seq 4096,    global batch 256
  prefill_32k — inference prefill,  seq 32768,   global batch 32
  decode_32k  — one decode token,   KV ctx 32768, global batch 128
  long_500k   — one decode token,   ctx 524288,  global batch 1
                (sub-quadratic archs only: SWA / SSM / hybrid)

``kind`` selects which program the dry-run lowers: train_step (train),
prefill (prefill) or serve_step (decode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.models.api import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> List[ShapeSpec]:
    """The assigned 4-shape set, minus long_500k for pure full-attention
    archs (quadratic prefill / unbounded KV — skip noted in DESIGN.md)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
