"""Times the MoE configs' decode and train steps on one GPU with the
``repro_torch`` of each source tree given, to compare two versions of the
MoE dispatch (``models/moe.py``) in one run.

    python3 tools/moe_dispatch_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout; it runs in a fresh subprocess with
``TREE/src`` first on the path (its kernels built into ``TREE/build``), in
the order given, so ``parent change change parent`` compares two commits
on the same card.  Per tree, for qwen3-moe-235b-a22b and grok-1-314b at
their published widths (bfloat16, random init from seed 0):

* decode: ``decode_step`` of B = 8 rows after a 32-token prefill, at the
  serving depth of ``chip_smoke.py`` (qwen3-moe 2 layers, grok-1 1); the
  median of 20 steps after 3 warm-ups, CUDA events;
* backward: the GRPO loss's forward and backward at 1 layer (remat), B =
  8 x 160 with 48 response tokens: the median of 3 after a warm-up, host
  clock, synchronised; for qwen3-moe also the whole train step
  (``make_train_step``, AdamW).  grok-1's AdamW state does not fit an
  80 GB card beside one layer's 6.5 G parameters and gradients, and the
  optimizer is the same code in both trees.

Prints one JSON line per tree, with the card's name and power limit, and
writes the list to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCHS = (("qwen3-moe-235b-a22b", 2), ("grok-1-314b", 1))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _batch(vocab, B, S, prompt):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(0)
    mask = torch.zeros((B, S))
    mask[:, prompt:] = 1.0
    batch = dict(
        tokens=torch.randint(3, min(vocab, 259), (B, S), generator=gen),
        loss_mask=mask,
        behavior_logp=-torch.rand((B, S), generator=gen) * 3 * mask,
        advantages=torch.randn((B,), generator=gen))
    return {k: v.cuda() for k, v in batch.items()}


def _decode_ms(cfg):
    import torch
    from repro_torch.models.api import get_model
    model = get_model(cfg)
    params = model.init(0, cfg, "cuda")
    B, P = 8, 32
    toks = _batch(cfg.vocab, B, P, P)["tokens"]
    times = []
    with torch.no_grad():
        lg, cache = model.prefill(params, cfg, toks, max_len=P + 24)
        for t in range(23):
            tok = torch.argmax(lg[:, :cfg.vocab].float(), -1).to(torch.int32)
            pos = torch.full((B,), P + t, dtype=torch.int32, device="cuda")
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            lg, cache = model.decode_step(params, cfg, cache, tok, pos)
            e1.record()
            e1.synchronize()
            if t >= 3:
                times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


def _timed(fn):
    """The median host-clock ms of 3 calls after a warm-up, each
    synchronised; fn returns the loss."""
    import torch
    times, losses = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(fn()))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:]), times, losses


def _train_ms(cfg, full_step):
    import torch
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, named_leaves
    from repro_torch.rl.grpo import grpo_loss, make_train_step
    model = get_model(cfg)
    params = model.init(0, cfg, "cuda").requires_grad_(True)
    leaves = [p for _, p in named_leaves(params)]
    batch = _batch(cfg.vocab, 8, 160, 112)

    def grads():
        with torch.enable_grad():
            logits = model.forward(params, cfg, batch["tokens"])
            loss, _ = grpo_loss(logits, batch["tokens"],
                                batch["behavior_logp"], batch["advantages"],
                                batch["loss_mask"])
            torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss

    out = dict(zip(("backward_ms", "backward_ms_all", "backward_losses"),
                   _timed(grads)))
    if full_step:
        opt = AdamWConfig(lr=3e-5)
        state = adamw_init(params, opt)
        step = make_train_step(cfg, opt)
        out.update(zip(("step_ms", "step_ms_all", "step_losses"),
                       _timed(lambda: step(params, state, batch)[2]["loss"])))
    return out


def child(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    out = {"tree": tree, "card": _card()}
    for arch, serve_layers in ARCHS:
        cfg = get_config(arch)
        dec, dec_all = _decode_ms(cfg.replace(n_layers=serve_layers))
        torch.cuda.empty_cache()
        out[arch] = dict(decode_ms=dec, decode_ms_all=dec_all,
                         decode_layers=serve_layers, **_train_ms(
                             cfg.replace(n_layers=1),
                             full_step=not arch.startswith("grok")))
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default="build/moe_dispatch_ab.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.trees[0])), flush=True)
        return 0
    results = []
    for tree in args.trees:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        run = subprocess.run([sys.executable, __file__, "--child", tree],
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
