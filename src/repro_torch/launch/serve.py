"""Rollout-serving launcher of the port (``--engine static``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-distill-1.5b \\
        --greedy
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The counterpart of ``repro.launch.serve``: same flags and the same setup
(tokenizer vocab, float32 weights, random init from ``--seed``), generation
through ``repro_torch.rl.rollout.RolloutEngine`` on the GPU unless
``--device`` says otherwise.  ``--engine paged`` is not ported yet
(ROADMAP M6).  ``--metrics PATH`` writes the reference's registry keys
(``serve/tokens``, ``serve/requests``, ``serve/tok_per_s``,
``serve/mean_len``, ``serve/completion_len``) as a JSON snapshot.
``run(argv)`` is the body; it returns the run's numbers as a dict.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.obs import log


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    log.add_flags(ap)
    ap.add_argument("--arch", default="qwen-distill-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("static", "paged"), default="static")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=0,
                    help="paged: concurrent sequences (0 -> batch size)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged: tokens per KV page (0 -> tuned default)")
    ap.add_argument("--radix", action="store_true",
                    help="paged: cross-request radix prefix cache")
    ap.add_argument("--turns", type=int, default=1,
                    help="paged: multi-turn episodes via a simulated tool env")
    ap.add_argument("--tool-tokens", type=int, default=12,
                    help="paged: observation tokens injected per turn")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default="",
                    help="write a metrics-registry snapshot JSON of the "
                         "serve run here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def run(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    log.configure(args)
    if args.engine == "paged":
        raise NotImplementedError("paged engine: ROADMAP M6")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
    from repro_torch.device import resolve_device
    from repro_torch.models.api import get_model
    from repro_torch.rl.rollout import GenConfig, RolloutEngine
    from repro_torch.rl.weight_sync import WeightStore

    device = resolve_device(args.device)
    tok = Tokenizer()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(vocab=tok.vocab_size, dtype="float32", remat=False)
    model = get_model(cfg)
    store = WeightStore()
    store.publish(model.init(args.seed, cfg, device))
    gen_cfg = GenConfig(max_new_tokens=args.max_new, greedy=args.greedy)
    tasks = MathTaskGenerator(seed=args.seed).batch(args.batch)
    engine = RolloutEngine(cfg, store, gen_cfg, rng_seed=args.seed,
                           device=device)

    t0 = time.time()
    rollouts, metrics = engine.generate(tasks)
    dt = time.time() - t0
    n_tok = sum(len(r.completion_ids) for r in rollouts)
    log.info(f"[{args.engine}] generated {n_tok} tokens for {args.batch} "
             f"requests in {dt:.2f}s  ({n_tok/dt:.1f} tok/s)  "
             f"mean_len={metrics['mean_len']:.1f}  "
             f"decode_slot_steps={metrics['decode_slot_steps']}",
             engine=args.engine, tokens=n_tok, batch=args.batch,
             seconds=dt, tok_per_s=n_tok / dt,
             mean_len=metrics["mean_len"],
             decode_slot_steps=metrics["decode_slot_steps"])
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
        registry.counter("serve/tokens").inc(n_tok)
        registry.counter("serve/requests").inc(args.batch)
        registry.gauge("serve/tok_per_s").set(n_tok / dt)
        registry.gauge("serve/mean_len").set(float(metrics["mean_len"]))
        lat_hist = registry.histogram("serve/completion_len")
        for ro in rollouts:
            lat_hist.observe(float(len(ro.completion_ids)))
        registry.to_json(args.metrics)
        log.info(f"metrics written to {args.metrics}",
                 metrics=args.metrics)
    r = rollouts[0]
    log.info(f"sample prompt:     {tok.decode(r.prompt_ids)!r}",
             prompt=tok.decode(r.prompt_ids))
    log.info(f"sample completion: {tok.decode(r.completion_ids)!r}",
             completion=tok.decode(r.completion_ids))
    return {"tokens": n_tok, "seconds": dt, "tok_per_s": n_tok / dt,
            "device": str(device), "rollouts": rollouts, **metrics}


if __name__ == "__main__":
    run()
