"""Rollout-serving launcher of the port: batched generation through
either engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-distill-1.5b \\
        --greedy
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
        --batch 16 --slots 4 --greedy
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --engine paged --greedy

The counterpart of ``repro.launch.serve``: same flags and the same setup
(tokenizer vocab, float32 weights, random init from ``--seed``), on the
GPU unless ``--device`` says otherwise.

  * ``--engine static`` (default): ``rl.rollout.RolloutEngine``, one
    right-padded batch.
  * ``--engine paged``: ``serve.PagedEngine``, continuous batching over
    the paged KV cache with ``--slots`` concurrent sequences and
    ``--page-size`` tokens per page; logs slot/page occupancy,
    preemptions and the ``EngineReport``.  ``--radix`` turns on the
    cross-request radix prefix cache; ``--turns N`` (N > 1, implies
    ``--radix``) drives multi-turn episodes through
    ``rl.agentic.MultiTurnDriver`` with a simulated tool env injecting
    ``--tool-tokens`` observation tokens per turn.

``--metrics PATH`` writes the reference's registry keys (``serve/tokens``,
``serve/requests``, ``serve/tok_per_s``, ``serve/mean_len``,
``serve/completion_len``, and for the paged engine
``serve/slot_occupancy``, ``serve/page_occupancy``,
``serve/preemptions``) as a JSON snapshot.  ``run(argv)`` is the body; it
returns the run's numbers as a dict.
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
                    help="paged: multi-turn episodes via a simulated tool "
                         "env (turns > 1 implies --radix)")
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

    import torch

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

    multi_turn = args.engine == "paged" and args.turns > 1
    if args.engine == "paged":
        from repro_torch.serve import PagedEngine, ServeConfig
        slots = args.slots or args.batch
        plen = max(len(t.prompt_ids) for t in tasks)
        extra = (args.turns - 1) * (args.max_new + args.tool_tokens)
        engine = PagedEngine(
            cfg, store, gen_cfg,
            ServeConfig(max_slots=slots,
                        max_len=plen + args.max_new + extra,
                        page_size=args.page_size or None,
                        radix=args.radix or multi_turn),
            rng_seed=args.seed, device=device)
    else:
        engine = RolloutEngine(cfg, store, gen_cfg, rng_seed=args.seed,
                               device=device)

    t0 = time.time()
    if multi_turn:
        import numpy as np
        from repro_torch.rl.agentic import (EnvConfig, MultiTurnDriver,
                                            SimToolEnv)
        drv = MultiTurnDriver(engine, SimToolEnv(EnvConfig(
            turns=args.turns, tool_tokens=args.tool_tokens,
            seed=args.seed)))
        episodes, metrics = drv.run(tasks, greedy=args.greedy)
        rollouts = [e.final for e in episodes]
        metrics["mean_len"] = float(np.mean(
            [len(r.completion_ids) for r in rollouts]))
        metrics["slot_occupancy"] = engine.stats.slot_occupancy
        metrics["page_occupancy"] = engine.stats.page_occupancy
        # the engine is this run's own, so its lifetime counts are the run's
        metrics["decode_steps"] = engine.stats.decode_steps
        metrics["decode_slot_steps"] = engine.stats.decode_slot_steps
        log.info(f"multi-turn: turns={metrics['turns']} "
                 f"env_calls={metrics['env_calls']} "
                 f"env_wait_s={metrics['env_wait_s']:.3f}  "
                 f"radix_hit_rate={metrics['radix_hit_rate']:.2f}",
                 turns=metrics["turns"], env_calls=metrics["env_calls"],
                 env_wait_s=metrics["env_wait_s"],
                 radix_hit_rate=metrics["radix_hit_rate"])
    else:
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
    if args.engine == "paged":
        log.info(f"slot_occupancy={metrics['slot_occupancy']:.2f}  "
                 f"page_occupancy={metrics['page_occupancy']:.2f}  "
                 f"preemptions={metrics['preemptions']}",
                 slot_occupancy=metrics["slot_occupancy"],
                 page_occupancy=metrics["page_occupancy"],
                 preemptions=metrics["preemptions"])
        from repro_torch.kernels import tuning
        from repro_torch.serve import EngineReport
        # the device-type name where the card has one, else the raw name
        dev = tuning.current_device_type() or (
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
        report = EngineReport.from_stats(
            engine.stats, dev, engine="paged",
            tokens_per_sec=n_tok / dt,
            turns_per_episode=float(metrics.get("turns", 1)),
            turn_gap_s=float(metrics.get("turn_gap_s", 0.0)))
        log.info(f"engine report: {report}", report=str(report))
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
        if args.engine == "paged":
            registry.gauge("serve/slot_occupancy").set(
                float(metrics["slot_occupancy"]))
            registry.gauge("serve/page_occupancy").set(
                float(metrics["page_occupancy"]))
            registry.counter("serve/preemptions").inc(
                int(metrics.get("preemptions", 0)))
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
