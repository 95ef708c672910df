"""End-to-end async GRPO training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --arch xlstm-1.3b --steps 2

The counterpart of ``repro.launch.train``: the same flags for the run
itself and the same setup (tokenizer vocab, float32 weights, no remat,
random init from ``--seed``), on the GPU unless ``--device`` says
otherwise.  It drives ``rl.async_trainer.AsyncGRPOTrainer`` through
produce (rollouts from the static engine, rule reward) -> GRPO policy
update (forward, backward, AdamW) -> weight publish -> the next rollouts,
admitted under the staleness bound ``--eta``.  ``--metrics PATH`` writes
the trainer's metrics registry (``buffer/*`` keys) as a JSON snapshot.

Checkpoints (``--ckpt-dir`` / ``--resume`` / ``--crash-after``),
``--schedule`` and ``--trace`` come with later slices.  ``run(argv)`` is
the body; it returns the run's numbers as a dict, with host-clock seconds
of each step's produce and train phases.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.obs import log


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    log.add_flags(ap)
    ap.add_argument("--arch", default="qwen-distill-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--prompts-per-step", type=int, default=2)
    ap.add_argument("--eta", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default="",
                    help="write a metrics-registry snapshot JSON of the "
                         "run here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def run(argv: Optional[List[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    log.configure(args)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.staleness import StalenessConfig
    from repro_torch.data.tasks import Tokenizer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(vocab=Tokenizer().vocab_size, dtype="float32",
                      remat=False)
    registry = None
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
    tc = TrainerConfig(
        group_size=args.group_size, prompts_per_step=args.prompts_per_step,
        total_steps=args.steps, seed=args.seed,
        staleness=StalenessConfig(
            eta=args.eta,
            rollouts_per_step=args.group_size * args.prompts_per_step),
        opt=AdamWConfig(lr=args.lr), metrics=registry)
    trainer = AsyncGRPOTrainer(cfg, tc, device=args.device)

    t0 = time.perf_counter()
    done, produced, decode_steps, steps = 0, 0, 0, []
    produce_s = 0.0
    while done < args.steps:
        tp = time.perf_counter()
        p = trainer.produce()
        produce_s += time.perf_counter() - tp
        if p["launched"]:
            produced += 1
            decode_steps += p["decode_steps"]
        tt = time.perf_counter()
        m = trainer.train_one()
        if m is None:
            continue
        train_s = time.perf_counter() - tt
        done += 1
        if done % tc.publish_every == 0:
            trainer.publish()
        st = trainer.buffer.stats()
        steps.append(dict(m, step=done, train_s=train_s,
                          produce_s=produce_s, version=trainer.store.version,
                          reward=trainer.rewarder.stats.mean, **st,
                          **{k: p[k] for k in ("fetch_s", "prefill_s",
                                               "decode_s", "decode_steps")
                             if k in p}))
        produce_s = 0.0
        if done % 5 == 0 or done == args.steps:
            log.info(f"[{done:4d}/{args.steps}] loss={m['loss']:.4f} "
                     f"reward={trainer.rewarder.stats.mean:.3f} "
                     f"staleness={st['mean_staleness']:.2f} "
                     f"elapsed={time.perf_counter() - t0:.0f}s",
                     step=done, steps=args.steps, loss=m["loss"],
                     reward=trainer.rewarder.stats.mean,
                     mean_staleness=st["mean_staleness"],
                     elapsed_s=time.perf_counter() - t0)
    if registry is not None:
        registry.to_json(args.metrics)
        log.info(f"metrics written to {args.metrics}", metrics=args.metrics)
    log.info("training complete")
    return {"steps": steps, "produced": produced,
            "decode_steps": decode_steps, "version": trainer.store.version,
            "seconds": time.perf_counter() - t0, "device": str(trainer.device),
            "n_layers": cfg.n_layers, "buffer": trainer.buffer.stats(),
            "eta": args.eta}


if __name__ == "__main__":
    run()
