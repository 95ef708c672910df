"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on the meta
device, the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen-distill-7b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Per cell this:
  1. builds the full-size ModelConfig,
  2. builds meta stand-ins for params / optimizer / cache / batch (no
     allocation anywhere) and places them as ``parallel.sharding`` says,
     as DTensors over the production mesh of a fake process group
     (``launch.mesh.make_production_mesh``: this process is rank 0 of
     256 / 512),
  3. runs the program on them (train_step for train_4k, prefill for
     prefill_32k, serve_step for decode_32k / long_500k) under
     ``CommDebugMode`` and ``launch.roofline.OpCounter``, which count the
     collectives DTensor issues and rank 0's local FLOPs and bytes,
  4. extracts the three roofline terms (+ collective inventory) and writes
     experiments/dryrun_torch/<arch>__<shape>__<mesh>.json in the
     reference's schema, with ``notes`` on what each field means here.

Counting runs the layers of a reduced-depth copy, L=4 and L=8 (layers are
homogeneous), and extrapolates linearly to full depth, as the reference
does; models of at most 12 layers are traced whole.  Memory needs no
trace: ``argument_bytes`` is the largest rank's shard of params,
optimizer state, batch and cache at full depth (DTensor splits uneven
dims with ``torch.chunk`` sizes).

Batch mode (--all) runs each cell in a fresh subprocess (process-group
isolation + resumability: existing JSONs are skipped unless --force).
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

from repro_torch.obs import log

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
TRACE_LAYERS = (4, 8)       # reduced depths counted, then extrapolated
FULL_TRACE_MAX = 12         # models this shallow are traced whole

NOTES = (
    "PyTorch port dry-run: DTensors on the meta device over a fake "
    "process group (rank 0's view), nothing executed. cost_analysis: "
    "rank 0's local ops counted by launch.roofline.OpCounter (FLOPs from "
    "torch.utils.flop_counter formulas, bytes = each eager op's inputs "
    "read once and outputs written once, views free; attention and the "
    "mLSTM scan counted as their plain PyTorch versions, which the "
    "kernel wrappers run on meta); calibration_factor ~ 1/n_devices "
    "means per-rank counts. The eager trace counts every loop trip, so "
    "mix_correction_flops = 0 (no loop_flop_correction). Collectives: "
    "the functional collectives DTensor issued (counts also from "
    "CommDebugMode in comm_debug_counts), wire bytes by the ring "
    "formulas of parse_collectives; the fake group is a CPU group, on "
    "which DTensor lowers all-to-all to all-gather + chunk. Multi-pod "
    "cells are traced on the (32, 16) view of the (2, 16, 16) mesh "
    "(pod and data merged, pod-major: the same shards on every rank), so "
    "a collective over the merged axis stands for the pod + data pair. "
    "memory_analysis: argument_bytes = the largest rank's shard of "
    "params, optimizer state, batch and cache at full depth; "
    "output_bytes = the largest rank's outputs, alias_bytes = those "
    "updated in place; temp_bytes = null (meta has no allocator). "
    "lower_s = 0 (no lowering), compile_s = the counting traces' wall "
    "time, scan_compile_s = building the full-depth stand-ins. Roofline "
    "terms are modelled from the H100 SXM5 data sheet, not measured.")


def _cell_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> Path:
    safe = arch.replace("/", "_")
    sfx = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{safe}__{shape}__{mesh_name}{sfx}.json"


def _local_nbytes(x) -> int:
    """Bytes rank 0 holds of a (D)Tensor output (the largest chunk)."""
    import torch
    from repro_torch.parallel.local import is_dt
    if isinstance(x, dict):
        return sum(_local_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_local_nbytes(v) for v in x)
    if is_dt(x):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


# --------------------------------------------------------------- programs
class Program:
    """One cell's placed inputs and its function, at one depth."""

    def __init__(self, cfg, shape, mesh):
        import torch
        from repro_torch.models.api import (cache_specs, param_specs,
                                            train_input_specs)
        from repro_torch.parallel import sharding as shd
        from repro_torch.parallel.mesh import axis_shape

        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        params = param_specs(cfg)
        # serving (prefill/decode): weights are read-only → fully shard
        # over data axes too when the model-axis shard alone exceeds the
        # HBM budget (stationary weights, all-gathered per layer);
        # small/mid models keep TP-only weights (no per-step gathers).
        msize = axis_shape(mesh).get("model", 1)
        per_dev = sum(p.numel() * p.element_size()
                      for p in params.parameters()) / msize
        self.fsdp = cfg.fsdp_params or (shape.kind != "train"
                                        and per_dev > 8e9)
        self.p_specs = shd.param_pspecs(params, cfg, mesh, fsdp=self.fsdp)
        self.params = params
        param_bytes = shd.local_bytes(params, self.p_specs, mesh)
        self.args_bytes, self.alias_bytes = param_bytes, 0
        B, S = shape.global_batch, shape.seq_len
        self.kind = shape.kind
        if shape.kind == "train":
            self.o_specs = shd.opt_state_pspecs(params, cfg, mesh)
            opt_bytes = 2 * shd.local_bytes(
                shd.map_with_path(lambda _, p: p.float(), params),
                self.o_specs, mesh)
            self.batch = train_input_specs(cfg, batch=B, seq_len=S)
            self.b_specs = shd.batch_pspecs(
                self.batch, mesh, include_model=cfg.shard_mode == "dp")
            self.args_bytes += opt_bytes + shd.local_bytes(
                self.batch, self.b_specs, mesh)
            self.alias_bytes = param_bytes + opt_bytes
        elif shape.kind == "prefill":
            self.batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                                device="meta")}
            if cfg.family in ("encdec", "vlm"):
                key = "frames" if cfg.family == "encdec" else "patches"
                self.batch[key] = torch.empty(
                    (B, cfg.encoder_seq, cfg.enc_dim), dtype=cfg.tdtype,
                    device="meta")
            self.b_specs = shd.batch_pspecs(self.batch, mesh)
            self.args_bytes += shd.local_bytes(self.batch, self.b_specs,
                                               mesh)
        else:
            self.cache = cache_specs(cfg, batch=B, ctx_len=S)
            self.c_specs = shd.cache_pspecs(self.cache, cfg, mesh)
            self.batch = {k: torch.empty((B,), dtype=torch.int32,
                                         device="meta")
                          for k in ("token", "pos")}
            self.b_specs = shd.batch_pspecs(self.batch, mesh)
            cache_bytes = shd.local_bytes(self.cache, self.c_specs, mesh)
            self.args_bytes += cache_bytes + shd.local_bytes(
                self.batch, self.b_specs, mesh)
            self.alias_bytes = cache_bytes

    def run(self):
        """Place the stand-ins and run the program once; returns its
        outputs (DTensors on meta)."""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.parallel import sharding as shd
        from repro_torch.rl.grpo import (make_prefill, make_serve_step,
                                         make_train_step)
        cfg, mesh = self.cfg, self.mesh
        params = shd.distribute(self.params, self.p_specs, mesh)

        def place(tree, specs):
            return {k: distribute_tensor(v, mesh, shd.placements(specs[k],
                                                                 mesh))
                    for k, v in tree.items()}

        if self.kind == "train":
            params.requires_grad_()
            o_flat = shd.flat(self.o_specs)
            st = adamw_init(self.params)
            opt = {"m": place(st["m"], o_flat), "v": place(st["v"], o_flat),
                   "count": 0}
            _, _, metrics = make_train_step(cfg)(
                params, opt, place(self.batch, self.b_specs))
            return metrics
        if self.kind == "prefill":
            batch = place(self.batch, self.b_specs)
            tokens = batch.pop("tokens")
            return make_prefill(cfg, max_len=self.shape.seq_len)(
                params, tokens, **batch)
        cache = shd.distribute(self.cache, self.c_specs, mesh)
        batch = place(self.batch, self.b_specs)
        return make_serve_step(cfg)(params, cache, batch["token"],
                                    batch["pos"])


def _count(cfg, shape, mesh):
    """Run the cell's program at ``cfg``'s depth under the counters."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.roofline import OpCounter
    prog = Program(cfg, shape, mesh)
    comm = CommDebugMode()
    with comm, OpCounter() as oc, implicit_replication():
        out = prog.run()
    counts = {str(k).split(".")[-1]: int(v)
              for k, v in comm.get_comm_counts().items()}
    return oc, counts, _local_nbytes(out)


def trace_mesh(mesh):
    """The mesh the counting runs on.  On the multi-pod mesh, the
    ("pod", "data") pair shards every batch and ZeRO dim together
    (``parallel.mesh.data_axes``), pod-major, so its (32, 16) view with
    the pair merged into one "data" axis gives every rank the same shards;
    DTensor plans its redistributions over two batch mesh dims far more
    slowly.  A collective over the merged axis stands for the pod and data
    pair."""
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.parallel.mesh import axis_shape
    shape = axis_shape(mesh)
    if "pod" not in shape:
        return mesh
    return make_fake_mesh((shape["pod"] * shape["data"], shape["model"]),
                          ("data", "model"))


def _reduced(cfg, L):
    kw = dict(n_layers=L)
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = max(
            1, round(cfg.n_encoder_layers * L / cfg.n_layers))
    return cfg.replace(**kw)


def count_program(cfg, shape, mesh):
    """Rank 0's cost of the cell's program at ``cfg``'s full depth:
    ``({"flops", "bytes accessed"}, {"counts", "wire_bytes"}, the
    CommDebugMode counts, rank 0's output bytes, extrapolated)``.  Models
    deeper than ``FULL_TRACE_MAX`` layers are counted at the
    ``TRACE_LAYERS`` depths and extrapolated linearly."""
    L = cfg.n_layers
    if L <= FULL_TRACE_MAX:
        oc, comm, out_bytes = _count(cfg, shape, mesh)
        cost = {"flops": oc.flops, "bytes accessed": oc.bytes}
        coll = {"counts": dict(oc.coll.counts),
                "wire_bytes": dict(oc.coll.wire_bytes)}
        return cost, coll, comm, out_bytes, False
    L1, L2 = TRACE_LAYERS
    lo, comm_lo, _ = _count(_reduced(cfg, L1), shape, mesh)
    oc, comm, out_bytes = _count(_reduced(cfg, L2), shape, mesh)
    scale = (L - L2) / (L2 - L1)

    def ext(hi, lo_):
        return hi + (hi - lo_) * scale

    cost = {"flops": ext(oc.flops, lo.flops),
            "bytes accessed": ext(oc.bytes, lo.bytes)}
    keys = set(oc.coll.counts) | set(lo.coll.counts)
    coll = {
        "counts": {k: int(round(ext(oc.coll.counts.get(k, 0),
                                    lo.coll.counts.get(k, 0))))
                   for k in keys},
        "wire_bytes": {k: ext(oc.coll.wire_bytes.get(k, 0.0),
                              lo.coll.wire_bytes.get(k, 0.0))
                       for k in keys},
    }
    comm = {k: int(round(ext(comm.get(k, 0), comm_lo.get(k, 0))))
            for k in set(comm) | set(comm_lo)}
    return cost, coll, comm, out_bytes, True


# --------------------------------------------------------------- one cell
def run_cell(arch: str, shape_name: str, mesh_name: str,
             save: bool = True, overrides: dict | None = None,
             tag: str = "") -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, applicable_shapes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch import roofline as rf

    base_cfg = get_config(arch)
    if overrides:
        base_cfg = base_cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    cfg = base_cfg
    if shape not in applicable_shapes(cfg):
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped",
                  "reason": "long_500k needs sub-quadratic attention "
                            "(full-attention arch)"}
        if save and not tag:
            RESULTS_DIR.mkdir(parents=True, exist_ok=True)
            _cell_path(arch, shape_name, mesh_name).write_text(
                json.dumps(result, indent=2))
        return result

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    n_dev = mesh.size()
    t0 = time.time()
    full = Program(base_cfg, shape, mesh)          # memory at full depth
    t_scan = time.time() - t0
    mesh = trace_mesh(mesh)

    t1 = time.time()
    cost, coll, comm, out_bytes, extrapolated = count_program(
        base_cfg, shape, mesh)
    t_count = time.time() - t1
    log.info("cost: flops=%.3e bytes=%.3e%s" %
             (cost["flops"], cost["bytes accessed"],
              " (extrapolated)" if extrapolated else ""),
             flops=cost["flops"], bytes_accessed=cost["bytes accessed"],
             extrapolated=extrapolated)

    out_bytes = max(out_bytes, full.alias_bytes)
    mem = {"argument_bytes": full.args_bytes, "output_bytes": out_bytes,
           "temp_bytes": None, "alias_bytes": full.alias_bytes}
    mem_per_dev = full.args_bytes + out_bytes - full.alias_bytes
    calib = rf.calibrate_cost_analysis(mesh)
    roof = rf.build_roofline(
        arch=arch, shape=shape_name, mesh_name=mesh_name, n_devices=n_dev,
        cost=cost, hlo_text="", model_flops=rf.model_flops_for_cell(
            cfg, shape),
        mem_per_dev_bytes=mem_per_dev, calib_factor=calib,
        mix_correction_flops=0.0, collectives_override=coll,
        n_calib=n_dev)
    roof.notes = f"modelled: {rf.HARDWARE}"

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_devices": n_dev,
        "lower_s": 0.0, "compile_s": round(t_count, 2),
        "scan_compile_s": round(t_scan, 2),
        "memory_analysis": mem,
        "cost_analysis": cost,
        "calibration_factor": calib,
        "mix_correction_flops": 0.0,
        "fsdp_params": full.fsdp,
        "extrapolated": extrapolated,
        "comm_debug_counts": comm,
        "hardware": rf.HARDWARE,
        "notes": NOTES,
        "roofline": roof.to_json(),
    }
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        if tag:
            result["overrides"] = {k: str(v)
                                   for k, v in (overrides or {}).items()}
        _cell_path(arch, shape_name, mesh_name, tag).write_text(
            json.dumps(result, indent=2))
    summary = {k: result[k] for k in
               ("arch", "shape", "mesh", "status", "lower_s", "compile_s")}
    log.info(json.dumps(summary), **summary)
    log.info("roofline (modelled, H100 SXM data sheet): compute=%.4fs "
             "memory=%.4fs collective=%.4fs -> %s" %
             (roof.t_compute, roof.t_memory, roof.t_collective,
              roof.bottleneck),
             t_compute=roof.t_compute, t_memory=roof.t_memory,
             t_collective=roof.t_collective, bottleneck=roof.bottleneck)
    return result


def _failed(arch, shape_name, mesh_name, err: str, save: bool) -> dict:
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "failed", "error": err[-4000:]}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        _cell_path(arch, shape_name, mesh_name).write_text(
            json.dumps(result, indent=2))
    return result


# --------------------------------------------------------------- all cells
def run_all(meshes, archs=None, shapes=None, force=False,
            timeout: int = 3600) -> None:
    from repro_torch.configs import list_archs
    from repro_torch.configs.shapes import SHAPES
    # the reference's ten assigned archs and the paper's three models
    archs = archs or list_archs()
    shapes = shapes or list(SHAPES)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                out = _cell_path(arch, shape, mesh_name)
                if out.exists() and not force:
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", mesh_name]
                log.info(f"\n=== {arch} × {shape} × {mesh_name} ===",
                         arch=arch, shape=shape, mesh=mesh_name)
                try:
                    r = subprocess.run(cmd, timeout=timeout)
                    if r.returncode != 0:
                        failures.append((arch, shape, mesh_name,
                                         f"exit {r.returncode}"))
                except subprocess.TimeoutExpired:
                    failures.append((arch, shape, mesh_name, "timeout"))
    if failures:
        log.info("\nFAILURES:", failures=failures)
        for f in failures:
            log.info(f"   {f}")
        sys.exit(1)
    log.info("\nall requested dry-run cells green")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (hillclimb knobs)")
    ap.add_argument("--tag", default="", help="suffix for the result JSON")
    ap.add_argument("--timeout", type=int, default=3600)
    log.add_flags(ap)
    args = ap.parse_args()
    log.configure(args)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs = [args.arch] if args.arch else None
        shapes = [args.shape] if args.shape else None
        run_all(meshes, archs=archs, shapes=shapes, force=args.force,
                timeout=args.timeout)
        return
    assert args.arch and args.shape, "--arch and --shape required"
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = (v if not v.replace("-", "").isdigit() else int(v))
        if v in ("True", "False"):
            overrides[k] = v == "True"
    for m in meshes:
        try:
            res = run_cell(args.arch, args.shape, m,
                           overrides=overrides or None, tag=args.tag)
        except Exception:
            err = traceback.format_exc()
            log.info(err)
            res = _failed(args.arch, args.shape, m, err,
                          save=not args.tag)
        if res.get("status") not in ("ok", "skipped"):
            sys.exit(1)


if __name__ == "__main__":
    main()
