"""The port's roofline host math against the reference's
(``repro.launch.roofline``): ``parse_collectives`` on HLO strings,
``model_flops_for_cell`` and ``loop_flop_correction`` for every arch x
shape, ``build_roofline`` (the same per-device numbers, terms at the H100
data-sheet constants), no TPU constant anywhere in the port, and the op
counter: FLOPs and bytes of known ops, and its calibration over a
sharded matmul on a fake process group (per-rank semantics)."""
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_rf
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline as rf

ROOT = Path(__file__).resolve().parents[1]

HLOS = [
    """
      %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}
      %ag.1 = bf16[64]{0} all-gather(%y), replica_groups={{0,1}}
      %rs = f32[32]{0} reduce-scatter(%z), replica_groups={{0,1,2,3}}
      %done = f32[8]{0} all-reduce-done(%h)
      %cp = (s32[4]{0}, s32[4]{0}) collective-permute(%a, %b)
    """,
    """
      %s = bf16[16,1024]{1,0} all-gather-start(%p), replica_groups=[16,16]
      %d = bf16[16,1024]{1,0} all-gather-done(%s)
      %a2a = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-to-all(%u, %v), replica_groups={{0,1,2,3,4,5,6,7}}
      %ar2 = (f32[4]{0}, bf16[2,2]{1,0}) all-reduce(%q, %r), replica_groups=[2,8]
      %x = u8[100]{0} all-reduce(%w)
      %y = f32[3]{0} add(%l, %r)
    """,
    "",
]


@pytest.mark.parametrize("i", range(len(HLOS)))
def test_parse_collectives_matches_reference(i):
    port, ref = rf.parse_collectives(HLOS[i]), ref_rf.parse_collectives(HLOS[i])
    assert port.counts == ref.counts
    assert port.result_bytes == ref.result_bytes
    assert port.wire_bytes == ref.wire_bytes
    assert port.total_wire_bytes == ref.total_wire_bytes
    if i == 0:
        assert port.wire_bytes["all-reduce"] == pytest.approx(
            2 * 3 / 4 * 128 * 256 * 4)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_loop_correction_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        shp, rshp = SHAPES[name], REF_SHAPES[name]
        for port, ref in ((rf.model_flops_for_cell(cfg, shp),
                           ref_rf.model_flops_for_cell(rcfg, rshp)),
                          (rf.loop_flop_correction(cfg, shp),
                           ref_rf.loop_flop_correction(rcfg, rshp))):
            assert math.isclose(port, ref, rel_tol=1e-12, abs_tol=0.0), \
                (name, port, ref)
    for S, w in ((4096, None), (4096, 4096), (32768, 4096), (7, 3)):
        assert rf._avg_causal_ctx(S, w) == ref_rf._avg_causal_ctx(S, w)


def test_build_roofline_at_h100_constants():
    kw = dict(arch="a", shape="train_4k", mesh_name="single", n_devices=256,
              cost={"flops": 3.0e14, "bytes accessed": 2.0e12},
              hlo_text=HLOS[0], model_flops=5.0e16,
              mem_per_dev_bytes=7.0e9, mix_correction_flops=2.56e14)
    # the reference calibrated over 1 device: per-device semantics
    ref = ref_rf.build_roofline(calib_factor=1.0, **kw)
    per = rf.build_roofline(calib_factor=1 / 256, n_calib=256, **kw)
    # a global count over 256 ranks gives the same per-device numbers
    glob = rf.build_roofline(calib_factor=1.0, n_calib=256,
                             **dict(kw, cost={"flops": 3.0e14 * 256,
                                              "bytes accessed": 2.0e12 * 256}))
    for r in (glob, per):
        for f in ("hlo_gflops_per_dev", "hlo_gbytes_per_dev",
                  "wire_gbytes_per_dev", "model_gflops",
                  "useful_flops_ratio", "memory_per_dev_gb"):
            assert getattr(r, f) == pytest.approx(getattr(ref, f),
                                                  rel=1e-12), f
        assert r.counts == ref.counts and r.collectives == ref.collectives
        assert r.t_compute == pytest.approx(
            r.hlo_gflops_per_dev * 1e9 / 989e12, rel=1e-12)
        assert r.t_memory == pytest.approx(
            r.hlo_gbytes_per_dev * 1e9 / 3.35e12, rel=1e-12)
        assert r.t_collective == pytest.approx(
            r.wire_gbytes_per_dev * 1e9 / 4.5e11, rel=1e-12)
        terms = {"compute": r.t_compute, "memory": r.t_memory,
                 "collective": r.t_collective}
        assert r.bottleneck == max(terms, key=terms.get)
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12,
                                                      4.5e11)
    over = rf.build_roofline(
        calib_factor=1 / 256, n_calib=256, collectives_override={
            "counts": {"all-gather": 3}, "wire_bytes": {"all-gather": 9e9}},
        **kw)
    assert over.counts == {"all-gather": 3}
    assert over.wire_gbytes_per_dev == pytest.approx(9.0)


TPU_CONSTANTS = re.compile(
    r"(?<![\w.])(197e12|1\.97e14|197e\+12|819e9|8\.19e11|819e\+9|50e9|"
    r"5e10|5\.0e10|50e\+9)(?![\w.])")


def _tpu_profile_lines():
    """Lines of ``core/cluster.py``'s ``TPU_V5E`` device profile: the
    scheduler's model of a TPU device in the reference's heterogeneous
    clusters (``tpu_heterogeneous``), not a figure of the card.  It stays:
    ``PROFILES``' order is part of every plan the port reproduces."""
    lines = (ROOT / "src/repro_torch/core/cluster.py").read_text() \
        .splitlines()
    start = lines.index("TPU_V5E = DeviceProfile(") + 1
    end = start + lines[start - 1:].index(")")
    return set(range(start, end + 1))


def test_no_tpu_constant_in_the_port():
    hits = []
    profile = _tpu_profile_lines()
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        rel = str(path.relative_to(ROOT))
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if rel == "src/repro_torch/core/cluster.py" and n in profile:
                continue
            if TPU_CONSTANTS.search(line.replace("_", "")):
                hits.append(f"{rel}:{n}: {line.strip()}")
    assert not hits, hits
    assert len(profile) < 12           # the exemption is that block only
    assert not TPU_CONSTANTS.search(
        (ROOT / "src/repro_torch/launch/roofline.py").read_text())


def test_op_counter_on_plain_meta_ops():
    meta = torch.device("meta")
    a = torch.empty(64, 128, device=meta)
    b = torch.empty(128, 32, device=meta, dtype=torch.float32)
    with rf.OpCounter() as oc:
        c = a @ b                       # 2*64*128*32 FLOPs
        c.t()                           # a view: free
        torch.exp(c)                    # no FLOP formula, bytes in + out
    assert oc.flops == 2 * 64 * 128 * 32
    mm_bytes = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert oc.bytes == mm_bytes + 2 * 64 * 32 * 4
    assert oc.coll.counts == {}
    # tensors off the counted device are DTensor's bookkeeping: not counted
    with rf.OpCounter() as oc:
        torch.ones(4) @ torch.ones(4, 2)
    assert oc.flops == 0 and oc.bytes == 0


CALIB = textwrap.dedent("""
    import json, torch
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch import roofline as rf
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    f = rf.calibrate_cost_analysis(mesh)
    meta = torch.device("meta")
    x = distribute_tensor(torch.empty(8, 16, device=meta), mesh,
                          [Shard(0), Shard(1)])
    with rf.OpCounter() as oc:
        x.redistribute(mesh, [Shard(0), Replicate()])
    print(json.dumps({"factor": f, "n": mesh.size(),
                      "counts": oc.coll.counts, "wire": oc.coll.wire_bytes,
                      "result": oc.coll.result_bytes}))
""")


def test_calibration_and_collectives_over_a_fake_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", CALIB], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["factor"] == pytest.approx(1 / res["n"])   # per rank
    # gathering a [4, 4] shard over the 4-rank model axis: a [4, 16]
    # result, (g - 1) / g of it on the wire
    assert res["counts"] == {"all-gather": 1}
    assert res["result"]["all-gather"] == 4 * 16 * 4
    assert res["wire"]["all-gather"] == pytest.approx(3 / 4 * 4 * 16 * 4)
