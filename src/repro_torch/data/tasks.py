"""Synthetic math-reasoning tasks + byte-level tokenizer.

The paper trains GRPO on mathematical reasoning; this module provides the
self-contained substitute: arithmetic-chain problems with verifiable integer
answers (rule-based reward = exact match, as in the paper's math setting),
and a tiny deterministic tokenizer so the whole RL loop runs offline.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


class Tokenizer:
    """Byte-level tokenizer with special tokens."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] if bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - self.OFFSET for i in ids
                   if i >= self.OFFSET)
        return bs.decode("utf-8", errors="replace")


@dataclass
class MathTask:
    prompt: str
    answer: int
    prompt_ids: List[int]


class MathTaskGenerator:
    """Arithmetic-chain problems: a ± b * c ... = ?  (ints, verifiable)."""

    def __init__(self, seed: int = 0, min_ops: int = 2, max_ops: int = 4,
                 max_operand: int = 99):
        self.rng = random.Random(seed)
        self.tok = Tokenizer()
        self.min_ops = min_ops
        self.max_ops = max_ops
        self.max_operand = max_operand

    def sample(self) -> MathTask:
        n_ops = self.rng.randint(self.min_ops, self.max_ops)
        expr = str(self.rng.randint(0, self.max_operand))
        for _ in range(n_ops):
            op = self.rng.choice(["+", "-", "*"])
            operand = self.rng.randint(0, self.max_operand if op != "*"
                                       else 9)
            expr += f" {op} {operand}"
        answer = eval(expr)          # safe: generated arithmetic only
        prompt = f"Q: {expr} = ?\nA:"
        return MathTask(prompt=prompt, answer=answer,
                        prompt_ids=self.tok.encode(prompt))

    def batch(self, n: int) -> List[MathTask]:
        return [self.sample() for _ in range(n)]

    def equal_length_batch(self, n: int) -> List[MathTask]:
        """n tasks sharing one prompt length — the case where a static
        right-padded engine and the paged serving engine are exactly
        equivalent (no padding → identical RoPE positions), used by the
        engine-identity tests and fig9."""
        bylen: dict = {}
        while True:
            t = self.sample()
            bylen.setdefault(len(t.prompt_ids), []).append(t)
            best = max(bylen.values(), key=len)
            if len(best) >= n:
                return best[:n]

    # ------------------------------------------------------------- reward
    def reward(self, task: MathTask, completion_ids: Sequence[int],
               shaped: bool = False) -> float:
        """Rule-based verification (paper: math reward on CPU).

        Exact integer match → 1.0.  With ``shaped=True`` a dense partial
        credit (fraction of the answer's digit string present as a
        subsequence, ×0.3) is added so RL-from-scratch demos get gradient
        signal before the first exact hit."""
        text = self.tok.decode(list(completion_ids))
        for tokpiece in text.replace("\n", " ").split():
            try:
                if int(tokpiece) == task.answer:
                    return 1.0
            except ValueError:
                continue
        if not shaped:
            return 0.0
        target = str(task.answer)
        it = iter(text)
        hit = sum(1 for ch in target if ch in it)
        return 0.3 * hit / max(len(target), 1)
