"""End-to-end async GRPO training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4 --ckpt-dir /tmp/ckpt --ckpt-every 1 --crash-after 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4 --ckpt-dir /tmp/ckpt --resume --trace /tmp/trace.json

The counterpart of ``repro.launch.train``: the same flags for the run
itself and the same setup (tokenizer vocab, float32 weights, no remat,
random init from ``--seed``), on the GPU unless ``--device`` says
otherwise.  It drives ``rl.async_trainer.AsyncGRPOTrainer`` through
produce (rollouts from the static engine, rule reward) -> GRPO policy
update (forward, backward, AdamW) -> weight publish -> the next rollouts,
admitted under the staleness bound ``--eta``.

Atomic checkpoint/restart, as the reference has it: ``--ckpt-dir D``
saves the parameters, the AdamW state and the weight version every
``--ckpt-every`` completed steps (``ckpt.checkpoint``, the reference's
on-disk format); ``--resume [DIR]`` builds a fresh trainer from
``--seed``, restores the latest checkpoint of DIR (or of ``--ckpt-dir``)
into it, publishes it and continues to ``--steps``, and fails when there
is none; ``--crash-after N`` hard-exits (``os._exit(17)``) after N
completed steps.  As in the reference, a resumed run rebuilds the task
generator, the rollout RNG and the buffer from ``--seed``: its state at
the resumed step is the interrupted run's, its later rollouts are not.
``--trace PATH`` writes a Chrome-trace JSON of the run (``obs.Tracer``:
a produce and a train_step span per step, a publish instant per
publish); ``--metrics PATH`` the trainer's metrics registry (``buffer/*``
keys).  ``--schedule`` comes with the port of ``core/`` (the scheduler).

``run(argv)`` is the body: it returns the run's numbers as a dict, with
host-clock seconds of each step's produce and train phases and the step
it resumed from.  Its pieces (``launcher_config``, ``make_trainer``,
``resume``, ``train_loop``) let a caller drive the same loop with a
trainer of its own, e.g. at full width and reduced depth.
"""
from __future__ import annotations

import argparse
import os
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="restore the latest checkpoint and continue "
                         "(from DIR when given, else --ckpt-dir); fails "
                         "loudly when none exists")
    ap.add_argument("--crash-after", type=int, default=0, metavar="N",
                    help="hard-exit (os._exit(17), no cleanup) after N "
                         "completed steps: crash injection for exercising "
                         "--resume")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON of the run here "
                         "(view: https://ui.perfetto.dev)")
    ap.add_argument("--metrics", default="",
                    help="write a metrics-registry snapshot JSON of the "
                         "run here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def launcher_config(args: argparse.Namespace):
    """The reference launcher's setup: the arch's published (or smoke)
    config with the tokenizer's vocab, float32 and no remat."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tasks import Tokenizer
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return cfg.replace(vocab=Tokenizer().vocab_size, dtype="float32",
                       remat=False)


def make_trainer(args: argparse.Namespace, cfg, tracer=None, registry=None):
    """A fresh trainer from ``--seed`` with the launcher's settings."""
    from repro_torch.core.staleness import StalenessConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig
    tc = TrainerConfig(
        group_size=args.group_size, prompts_per_step=args.prompts_per_step,
        total_steps=args.steps, seed=args.seed,
        staleness=StalenessConfig(
            eta=args.eta,
            rollouts_per_step=args.group_size * args.prompts_per_step),
        opt=AdamWConfig(lr=args.lr), trace=tracer, metrics=registry)
    return AsyncGRPOTrainer(cfg, tc, device=args.device)


def resume(trainer, state: Dict) -> None:
    """Restore a checkpoint's params and AdamW state into ``trainer``,
    publish them and align the buffer's version with the store's."""
    from repro_torch.ckpt.checkpoint import load_trainer_state
    load_trainer_state(state, trainer.params, trainer.opt_state)
    trainer.store.publish(trainer.params)
    trainer.buffer.ctl.version = trainer.store.version


def train_loop(trainer, steps: int, *, step0: int = 0, mgr=None,
               crash_after: int = 0) -> Dict:
    """Produce / train / publish from step ``step0`` until ``steps``
    completed steps; save through ``mgr`` after each step and hard-exit
    (status 17) once ``crash_after`` steps are done."""
    from repro_torch.ckpt.checkpoint import trainer_state
    t0 = time.perf_counter()
    done, produced, decode_steps, hist = step0, 0, 0, []
    produce_s = 0.0
    while done < steps:
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
        if done % trainer.tc.publish_every == 0:
            trainer.publish()
        if mgr is not None:
            mgr.maybe_save(done, lambda: trainer_state(
                trainer.params, trainer.opt_state, trainer.store.version))
        if crash_after and done >= crash_after:
            log.info(f"injected crash after step {done}",
                     crash_after=crash_after)
            os._exit(17)    # hard kill: no atexit, no cleanup, a real crash
        st = trainer.buffer.stats()
        hist.append(dict(m, step=done, train_s=train_s, produce_s=produce_s,
                         version=trainer.store.version,
                         reward=trainer.rewarder.stats.mean, **st,
                         **{k: p[k] for k in ("fetch_s", "prefill_s",
                                              "decode_s", "decode_steps")
                            if k in p}))
        produce_s = 0.0
        if done % 5 == 0 or done == steps:
            log.info(f"[{done:4d}/{steps}] loss={m['loss']:.4f} "
                     f"reward={trainer.rewarder.stats.mean:.3f} "
                     f"staleness={st['mean_staleness']:.2f} "
                     f"elapsed={time.perf_counter() - t0:.0f}s",
                     step=done, steps=steps, loss=m["loss"],
                     reward=trainer.rewarder.stats.mean,
                     mean_staleness=st["mean_staleness"],
                     elapsed_s=time.perf_counter() - t0)
    return {"steps": hist, "produced": produced,
            "decode_steps": decode_steps, "version": trainer.store.version,
            "seconds": time.perf_counter() - t0,
            "device": str(trainer.device), "n_layers": trainer.cfg.n_layers,
            "buffer": trainer.buffer.stats()}


def run(argv: Optional[List[str]] = None) -> Dict:
    ap = parser()
    args = ap.parse_args(argv)
    log.configure(args)
    from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                             restore_checkpoint)

    resume_dir = None
    if args.resume is not None:
        resume_dir = args.resume or args.ckpt_dir
        if not resume_dir:
            ap.error("--resume needs a directory (or --ckpt-dir)")
    cfg = launcher_config(args)
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(meta={"launcher": "train", "arch": cfg.name})
    registry = None
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
    trainer = make_trainer(args, cfg, tracer, registry)
    mgr = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
           if args.ckpt_dir else None)

    restored = None
    if resume_dir is not None:
        # raises FileNotFoundError when there is no checkpoint
        restored = restore_checkpoint(resume_dir, device=trainer.device)
    elif mgr is not None:
        restored = mgr.restore_latest(device=trainer.device)
    step0 = 0
    if restored:
        step0, state = restored
        resume(trainer, state)
        del state, restored
        log.info(f"resumed from step {step0} "
                 f"(weight version {trainer.store.version})",
                 resumed_step=step0, resumed_version=trainer.store.version)

    out = train_loop(trainer, args.steps, step0=step0, mgr=mgr,
                     crash_after=args.crash_after)
    if tracer is not None:
        tracer.dump(args.trace)
        log.info(f"trace written to {args.trace} "
                 f"({tracer.n_events} events)", trace=args.trace,
                 events=tracer.n_events)
    if registry is not None:
        registry.to_json(args.metrics)
        log.info(f"metrics written to {args.metrics}", metrics=args.metrics)
    log.info("training complete", resumed_from=step0, steps=args.steps)
    return dict(out, resumed_from=step0, eta=args.eta)


if __name__ == "__main__":
    run()
