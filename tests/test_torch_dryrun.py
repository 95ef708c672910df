"""The port's meta-device dry-run and the sharded step it traces.

* The shape-only stand-ins (``models.api.train_input_specs`` /
  ``decode_input_specs`` / ``cache_specs`` / ``param_specs``) against the
  reference's ``eval_shape`` records: keys, shapes, dtypes; every family
  builds its tree on ``device="meta"`` and the CPU draws are untouched.
* ``rl.grpo.make_serve_step`` / ``make_prefill`` are the model's
  ``decode_step`` / ``prefill``.
* The counterpart of the reference's ``test_mini_dryrun_compiles_and_
  has_collectives``: the smoke train step of its five archs traced as
  DTensors on the meta device over a fake (2, 4) mesh, in a subprocess.
  XLA's and DTensor's collectives differ, so the counts pinned here are
  the port's own (collectives > 0 and FLOPs > 0 are the reference's
  checks); the same cells traced whole (mesh (1, 1)) are held to the
  reference's analytic ``model_flops_for_cell``, and rank 0's share to
  the whole.
* The TP plan on real CPU tensors: the qwen smoke train step at gloo
  world size 2 (mesh (1, 2)) gives the unsharded step's loss, grad_norm
  and updated parameters (f32, 2e-5); the sharded prefill and serve
  steps under each cache plan ("hd", "heads", "ctx") give the unsharded
  logits and cache.
* K3's log-sum-exp output (plain version): decodes over runs of the
  context merged by ``merge_lse`` equal the reference's decode.
* The CLI: one full-size cell written to a temporary results directory,
  and ``launch.report`` over it (tables, ``--update PATH``).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import api as ref_api
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import api
from repro_torch.rl.grpo import make_prefill, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
MINI_ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
              "hymba-1.5b", "whisper-small"]


def _run(code: str, *args, timeout=600):
    out = subprocess.run([sys.executable, "-c", code, *args], env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    return (tuple(tree.shape), np.dtype(str(tree.dtype).replace(
        "torch.", "")).name if "bfloat16" not in str(tree.dtype)
        else "bfloat16")


@pytest.mark.parametrize("arch", list_archs())
def test_stand_ins_match_reference(arch):
    cfg, rcfg = get_smoke_config(arch), ref_get_smoke(arch)
    assert _sig(api.train_input_specs(cfg, batch=4, seq_len=16)) == \
        _sig(ref_api.train_input_specs(rcfg, batch=4, seq_len=16))
    assert _sig(api.decode_input_specs(cfg, batch=4, ctx_len=16)) == \
        _sig(ref_api.decode_input_specs(rcfg, batch=4, ctx_len=16))
    port = api.cache_specs(cfg, batch=4, ctx_len=16)
    assert all(t.is_meta for t in port.values())
    assert _sig(port) == _sig(ref_api.cache_specs(rcfg, batch=4,
                                                  ctx_len=16))
    params = api.param_specs(cfg)
    assert all(p.is_meta for p in params.parameters())
    model = ref_api.get_model(rcfg)
    ref = jax.eval_shape(lambda k: model.init(k, rcfg),
                         jax.random.PRNGKey(0))
    assert _sig(params.tree()) == _sig(ref)


def test_meta_init_leaves_the_cpu_draws_alone():
    """A meta init draws nothing, so the CPU init of the same seed after it
    gives the tensors of a CPU init without it."""
    for arch in ("qwen-distill-1.5b", "xlstm-1.3b", "hymba-1.5b"):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        model = api.get_model(cfg)
        before = model.init(3, cfg, device="cpu").tree()
        meta = model.init(3, cfg, device="meta")
        after = model.init(3, cfg, device="cpu").tree()
        flat_b = dict(_flat(before))
        for k, v in _flat(after):
            assert torch.equal(v, flat_b[k]), (arch, k)
        assert all(p.is_meta for p in meta.parameters())


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + ".")
        else:
            yield pre + k, v


def test_serve_step_and_prefill_are_the_models():
    cfg = get_smoke_config("qwen-distill-1.5b").replace(dtype="float32")
    model = api.get_model(cfg)
    params = model.init(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 6), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    la, ca = make_prefill(cfg, max_len=16)(params, tokens)
    lb, cb = model.prefill(params, cfg, tokens, max_len=16)
    assert torch.equal(la, lb)
    tok = torch.tensor([3, 5], dtype=torch.int32)
    pos = torch.tensor([6, 6], dtype=torch.int32)
    sa, _ = make_serve_step(cfg)(params, ca, tok, pos)
    sb, _ = model.decode_step(params, cfg, cb, tok, pos)
    assert torch.equal(sa, sb)


MINI = textwrap.dedent("""
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import _count
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    whole = make_fake_mesh((1, 1), ("data", "model"))
    out = {}
    for arch in %r:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        oc, comm, _ = _count(cfg, ShapeSpec("mini", "train", 32, 4), mesh)
        one, _, _ = _count(cfg, ShapeSpec("mini", "train", 32, 4), whole)
        out[arch] = dict(flops=oc.flops, bytes=oc.bytes,
                         counts=oc.coll.counts, comm=comm,
                         flops_1x1=one.flops)
    print(json.dumps(out))
""") % (MINI_ARCHS,)

# the port's own counts (rank 0 of the fake (2, 4) mesh, batch 4 x 32)
PINNED = {
    "qwen2.5-3b": (35651584.0, {"all-reduce": 79, "all-gather": 48,
                                "reduce-scatter": 62}),
    "qwen3-moe-235b-a22b": (17760256.0, {"all-gather": 50, "all-reduce": 70,
                                         "reduce-scatter": 30}),
    "xlstm-1.3b": (43974656.0, {"all-reduce": 58, "all-gather": 29,
                                "reduce-scatter": 40}),
    "hymba-1.5b": (17397760.0, {"all-reduce": 138, "all-gather": 58,
                                "reduce-scatter": 77}),
    "whisper-small": (20883456.0, {"all-reduce": 180, "reduce-scatter": 208,
                                   "all-gather": 125}),
}
_FUNCOL = {"all-reduce": "all_reduce", "all-gather":
           "all_gather_into_tensor", "reduce-scatter":
           "reduce_scatter_tensor"}


@pytest.fixture(scope="module")
def mini():
    return _run(MINI)


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dryrun_traces_and_has_collectives(mini, arch):
    res = mini[arch]
    assert res["flops"] > 0 and res["bytes"] > 0
    assert sum(res["counts"].values()) > 0      # TP really sharded something
    flops, counts = PINNED[arch]
    assert res["flops"] == flops
    assert res["counts"] == counts
    # CommDebugMode saw the same collectives as the op counter
    assert res["comm"] == {_FUNCOL[k]: v for k, v in counts.items()}


# port FLOPs / (the reference's 6 N T + the attention products) of the
# mini cell traced whole (mesh (1, 1)): the smoke configs have no remat,
# so the step is one forward and one backward; the rest of the band is
# the norms, activations, router, loss and AdamW, which the analytic
# count leaves out.  xlstm's reference count approximates an mLSTM layer
# as 6 d^2 parameters (``ModelSpec.params``), about half of the block's
# projections, hence its own band.
FLOP_BAND = {"ssm": (1.5, 2.2)}
FLOP_BAND_DEFAULT = (1.0, 1.2)


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dryrun_flops_match_reference_count(mini, arch):
    """The op counter against the reference's analytic count
    (``repro.launch.roofline.model_flops_for_cell``): a missing backward
    (x 1/3), a double count (x 2) or a global count read as a rank's
    (x 8 at (2, 4)) falls outside the band or the rank bounds."""
    from repro.configs.shapes import ShapeSpec as RefShape
    from repro.launch.roofline import model_flops_for_cell
    res = mini[arch]
    rcfg = ref_get_smoke(arch).replace(dtype="float32")
    B, S = 4, 32
    ref = model_flops_for_cell(rcfg, RefShape("mini", "train", S, B))
    attn = 12.0 * rcfg.n_layers * rcfg.n_heads * rcfg.hd * S * B * S
    lo, hi = FLOP_BAND.get(rcfg.family, FLOP_BAND_DEFAULT)
    assert lo <= res["flops_1x1"] / (ref + attn) <= hi
    # rank 0 of the (2, 4) mesh does at least its 1/8 of the whole step
    # and less than all of it (DTensor replicates some of the small
    # smoke-width work over the model axis)
    assert res["flops_1x1"] / 8 <= res["flops"] < res["flops_1x1"]


TP = textwrap.dedent("""
    import json, os, socket, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port, path):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import \\
            implicit_replication
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.api import get_model
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.parallel import sharding as shd
        from repro_torch.rl.grpo import make_train_step
        mesh = make_host_mesh((1, 2), ("data", "model"), device="cpu")
        cfg = get_smoke_config("qwen-distill-1.5b").replace(dtype="float32")
        model = get_model(cfg)
        rng = np.random.default_rng(0)
        B, S = 4, 16
        batch = {
            "tokens": torch.tensor(rng.integers(0, cfg.vocab, (B, S)),
                                   dtype=torch.int32),
            "loss_mask": torch.tensor(rng.random((B, S)) > 0.3,
                                      dtype=torch.float32),
            "advantages": torch.tensor(rng.standard_normal(B),
                                       dtype=torch.float32),
            "behavior_logp": torch.tensor(-rng.random((B, S)) * 3,
                                          dtype=torch.float32)}
        step = make_train_step(cfg)
        ref = model.init(0, cfg, device="cpu").requires_grad_()
        _, _, rm = step(ref, adamw_init(ref), dict(batch))
        params = model.init(0, cfg, device="cpu")
        dp = shd.distribute(params, shd.param_pspecs(params, cfg, mesh),
                            mesh).requires_grad_()
        ospec = shd.flat(shd.opt_state_pspecs(params, cfg, mesh))
        st = adamw_init(params)
        opt = {k: {n: distribute_tensor(v, mesh, shd.placements(
                   ospec[n], mesh)) for n, v in st[k].items()}
               for k in ("m", "v")}
        opt["count"] = 0
        bsp = shd.batch_pspecs(batch, mesh)
        db = {k: distribute_tensor(v, mesh, shd.placements(bsp[k], mesh))
              for k, v in batch.items()}
        with implicit_replication():
            _, _, m = step(dp, opt, db)
        sharded = sum(any(p.is_shard() for p in t.placements)
                      for t in dp.parameters())
        err = max(float((a.detach().full_tensor() - b.detach()).abs().max())
                  for a, b in zip(dp.parameters(), ref.parameters()))
        out = dict(loss=float(m["loss"].full_tensor()),
                   ref_loss=float(rm["loss"]),
                   gn=float(m["grad_norm"].full_tensor()),
                   ref_gn=float(rm["grad_norm"]), param_err=err,
                   sharded=sharded)
        if rank == 0:
            json.dump(out, open(path, "w"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(worker, args=(port, sys.argv[1]), nprocs=2)
        print(open(sys.argv[1]).read())
""")


def test_tp_train_step_at_gloo_world_two_equals_unsharded(tmp_path):
    script = tmp_path / "tp.py"
    script.write_text(TP)
    out = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "out.json")], env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads((tmp_path / "out.json").read_text())
    assert res["sharded"] > 0                    # TP split some weights
    assert res["loss"] == pytest.approx(res["ref_loss"], rel=2e-5, abs=2e-5)
    assert res["gn"] == pytest.approx(res["ref_gn"], rel=2e-5, abs=2e-5)
    assert res["param_err"] <= 2e-5


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("n_runs", [2, 3])
def test_decode_runs_merged_by_lse_equal_reference(n_runs, window):
    """K3's ``lse`` output (its plain version here): the decode over a
    cache cut into runs of the context, merged by ``merge_lse``, equals
    the reference's decode over the whole cache; a row no run attends
    gives 0, and a run that attends nothing of a row weighs 0."""
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as jref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import merge_lse
    rng = np.random.default_rng(n_runs)
    B, H, Hkv, D, C = 4, 8, 2, 16, 37
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    q_pos = np.array([36, 20, 5, -1], np.int32)
    k_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    k_pos[1, 3:7] = -2 ** 30                       # empty slots
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(q_pos), jnp.asarray(k_pos),
                           window=window))
    cuts = np.linspace(0, C, n_runs + 1).astype(int)
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)]
    os_, ls = zip(*(decode_attention(t[0], t[1][:, a:b], t[2][:, a:b],
                                     t[3], t[4][:, a:b], window=window,
                                     return_lse=True)
                    for a, b in zip(cuts[:-1], cuts[1:])))

    def reduce(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    got = merge_lse(torch.stack(os_), torch.stack(ls), reduce).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert not got[3].any()
    # the lse itself: log sum exp of the attended scaled scores
    _, lse = decode_attention(*t, window=window, return_lse=True)
    s = np.einsum("bhgd,bchd->bhgc", q.reshape(B, Hkv, H // Hkv, D),
                  k) / np.sqrt(D)
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok &= k_pos > q_pos[:, None] - window
    for b in range(3):
        sb = s[b].reshape(H, C)[:, ok[b]].astype(np.float64)
        np.testing.assert_allclose(
            lse[b].numpy(), np.log(np.exp(sb).sum(-1)), rtol=1e-6)
    assert (lse[3] == -1e30).all()


SERVE = textwrap.dedent("""
    import json, os, socket, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port, path):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import \\
            implicit_replication
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.api import get_model
        from repro_torch.parallel import sharding as shd
        from repro_torch.rl.grpo import make_prefill, make_serve_step
        mesh = make_host_mesh((1, 2), ("data", "model"), device="cpu")
        rows = shd.placements(shd.P(("data",)), mesh)
        rng = np.random.default_rng(0)
        B, P, steps = 4, 8, 4
        out = {}
        for shard in ("hd", "heads", "ctx"):
            cfg = get_smoke_config("qwen-distill-1.5b").replace(
                dtype="float32", cache_shard=shard)
            model = get_model(cfg)
            params = model.init(0, cfg, device="cpu")
            toks = torch.tensor(rng.integers(0, cfg.vocab, (B, P)),
                                dtype=torch.int32)
            # 13 slots: the context split is uneven (7 + 6)
            prefill = make_prefill(cfg, max_len=P + 5)
            serve = make_serve_step(cfg)
            dparams = shd.distribute(
                params, shd.param_pspecs(params, cfg, mesh), mesh)
            with torch.no_grad(), implicit_replication():
                lg, cache = prefill(params, toks)
                dlg, dcache = prefill(
                    dparams, distribute_tensor(toks, mesh, rows))
                err = max([float((dlg.full_tensor() - lg).abs().max())] + [
                    float((dcache[n].full_tensor().float()
                           - cache[n].float()).abs().max())
                    for n in cache])
                for t in range(steps):
                    tok = torch.argmax(lg[:, :cfg.vocab], -1).to(
                        torch.int32)
                    pos = torch.full((B,), P + t, dtype=torch.int32)
                    dlg, dcache = serve(dparams, dcache, *(
                        distribute_tensor(x, mesh, rows)
                        for x in (tok, pos)))
                    lg, cache = serve(params, cache, tok, pos)
                    err = max(err, float((dlg.full_tensor()
                                          - lg).abs().max()))
            out[shard] = dict(err=err, placements=str(
                dcache["k"].placements))
        if rank == 0:
            json.dump(out, open(path, "w"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(worker, args=(port, sys.argv[1]), nprocs=2)
        print(open(sys.argv[1]).read())
""")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    (d / "serve.py").write_text(SERVE)
    out = subprocess.run([sys.executable, str(d / "serve.py"),
                          str(d / "out.json")], env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("shard,dim", [("hd", 4), ("heads", 3),
                                       ("ctx", 2)])
def test_sharded_prefill_and_serve_at_gloo_world_two_equal_unsharded(
        served, shard, dim):
    """The three cache plans over a model axis of 2 (gloo, CPU): the
    sharded prefill's logits and cache and four sharded decode steps'
    logits equal the unsharded model's (f32, 2e-5).  ``ctx`` writes each
    slot on the rank that holds it and merges the ranks' decodes by their
    log-sum-exp; ``hd`` runs K3's two head-dim passes (``decode_scores``,
    the all-reduce of the scores, ``decode_softmax_pv``; their plain
    versions on the CPU)."""
    res = served[shard]
    assert res["placements"] == f"(Shard(dim=1), Shard(dim={dim}))"
    assert res["err"] <= 2e-5


CLI = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    from repro_torch.launch import dryrun, report
    out = Path(sys.argv[1])
    dryrun.RESULTS_DIR = out
    report.RESULTS = out
    sys.argv = ["dryrun", "--arch", "qwen-distill-1.5b", "--shape",
                "decode_32k", "--mesh", "single", "--quiet"]
    dryrun.main()
    sys.argv = ["dryrun", "--arch", "qwen-distill-1.5b", "--shape",
                "long_500k", "--mesh", "single", "--quiet"]
    dryrun.main()
    doc = out / "doc.md"
    doc.write_text("head\\n" + report.BEGIN + "\\nold\\n" + report.END
                   + "\\ntail\\n")
    report.main(["--update", str(doc)])
    cell = json.loads((out / "qwen-distill-1.5b__decode_32k__single.json"
                       ).read_text())
    skip = json.loads((out / "qwen-distill-1.5b__long_500k__single.json"
                       ).read_text())
    print(json.dumps({"cell": cell, "skip": skip, "doc": doc.read_text()}))
""")


def test_dryrun_cli_cell_and_report(tmp_path):
    res = _run(CLI, str(tmp_path))
    cell = res["cell"]
    assert cell["status"] == "ok" and cell["n_devices"] == 256
    assert cell["mix_correction_flops"] == 0.0
    assert cell["calibration_factor"] == pytest.approx(1 / 256)
    assert cell["memory_analysis"]["temp_bytes"] is None
    assert cell["memory_analysis"]["argument_bytes"] > 0
    roof = cell["roofline"]
    assert sum(roof["counts"].values()) > 0
    assert roof["hlo_gflops_per_dev"] > 0 and roof["t_memory"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert "H100" in cell["hardware"] and "modelled" in roof["notes"]
    assert res["skip"]["status"] == "skipped"
    doc = res["doc"]
    assert doc.startswith("head\n") and doc.endswith("tail\n")
    assert "old" not in doc
    assert "| qwen-distill-1.5b | " in doc and "decode_32k" in doc
