"""The port's autotuner against the reference's (``repro.autotune``):
CostDB files read and written byte for byte by both packages, merges,
errors and interpolation equal, ``MeasuredCostModel`` factors and 1.5B
plans on 8 H800 + 8 H20 bit for bit (``_plan_parity.plain``), the
reference's roofline estimate, the tuning table (register / resolve /
clear / override, refused knobs and values), tuned knobs flowing into the
wrappers' launch parameters on CPU tensors, and the CLI on the CPU.

The reference's sweep never runs JAX here: its per-kernel calibration is
preset with ``monkeypatch``."""
import importlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _plan_parity import plain

import repro.autotune.bench as ref_bench
from repro.autotune import CostDB as RefCostDB
from repro_torch.autotune import (CostDB, CostDBSchemaError,
                                  CostDBVersionError, MeasuredCostModel,
                                  SCHEMA_VERSION, SPACES,
                                  card_fractions, load_tuned_defaults,
                                  run_sweep)
from repro_torch.autotune import bench, space as port_space
from repro_torch.kernels import tuning
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
# the reference's flop_calibration ratios on a CPU (flash, decode, paged,
# scan), preset so that its sweep runs no JAX interpreter
REF_CALIB = {"flash_attention": 1.463, "decode_attention": 0.883,
             "paged_attention": 0.977, "ssm_scan": 1.346}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def clean_tuning():
    tuning.clear_tuned()
    yield
    tuning.clear_tuned()


def _rec(pkg, size=4096, time_s=1e-3, mode="interpret", config=None, **over):
    kw = dict(shape={"B": 1, "S": size, "H": 8, "D": 128}, size=size,
              best_config=config or {"min_split_tiles": 8}, time_s=time_s,
              flops=4e10, useful_flops=3.5e10, bytes=3e8, mode=mode,
              configs_tried=8)
    kw.update(over)
    return mod(pkg, "autotune.costdb").Record(**kw)


def _ref_sweep(monkeypatch, device_types=("H800", "H20")):
    for k, v in REF_CALIB.items():
        monkeypatch.setitem(ref_bench._CALIB, k, v)
    from repro.autotune import run_sweep as ref_run_sweep
    return ref_run_sweep(tiny=True, device_types=list(device_types),
                         log=lambda s: None)


def _port_sweep(**kw):
    return run_sweep(tiny=True, device="cpu", log=lambda s: None, **kw)


# ------------------------------------------------------------------- CostDB
@pytest.mark.parametrize("writer", PKGS)
def test_costdb_files_round_trip_byte_for_byte(writer, tmp_path,
                                               monkeypatch):
    """A file one package wrote, the other loads and writes back
    identically (hand-made records and a whole tiny sweep)."""
    db_cls = {"repro": RefCostDB, "repro_torch": CostDB}
    db = db_cls[writer]()
    db.put("TPUv5e", "flash_attention", "b1_s4096", _rec(writer))
    db.put("H20", "paged_attention", "b32_c8192",
           _rec(writer, size=8192, time_s=1.25e-4, mode="device",
                config={"page_size": 64, "min_split_tiles": 16}))
    swept = (_ref_sweep(monkeypatch) if writer == "repro"
             else _port_sweep())
    for name, d in (("hand", db), ("sweep", swept)):
        first = tmp_path / f"{name}_{writer}.json"
        d.save(first)
        for reader in db_cls.values():
            back = tmp_path / f"{name}_back.json"
            reader.load(first).save(back)
            assert back.read_bytes() == first.read_bytes()


def test_card_records_stay_under_the_card_type():
    db = CostDB()
    db.put("H100", "decode_attention", "b", _rec("repro_torch",
                                                 mode="device"))
    assert db.device_types() == ["H100"]
    with pytest.raises(CostDBSchemaError, match="TPUv4"):
        db.put("TPUv4", "decode_attention", "b", _rec("repro_torch"))
    # the reference has no H100 profile and refuses the card's records
    with pytest.raises(mod("repro", "autotune.costdb").CostDBSchemaError,
                       match="H100"):
        RefCostDB.from_json(db.to_json())


def _merged(pkg):
    cdb = mod(pkg, "autotune.costdb")
    a = cdb.CostDB()
    a.put("H800", "flash_attention", "b", _rec(pkg, time_s=2e-3))
    b = cdb.CostDB()
    b.put("H800", "flash_attention", "b", _rec(pkg, time_s=1e-3))
    b.put("H20", "flash_attention", "b", _rec(pkg, time_s=9e-3))
    a.merge(b)
    steps = [a.to_json()]
    c = cdb.CostDB()
    c.put("H800", "flash_attention", "b", _rec(pkg, time_s=5e-3,
                                               mode="device"))
    a.merge(c)
    steps.append(a.to_json())
    d = cdb.CostDB()
    d.put("H800", "flash_attention", "b", _rec(pkg, time_s=1e-4))
    a.merge(d)   # an estimate never displaces a device measurement
    steps.append(a.to_json())
    return steps


def test_merge_equals_the_reference():
    ref, port = _merged("repro"), _merged("repro_torch")
    assert port == ref
    assert port[-1]["entries"]["H800"]["flash_attention"]["b"]["mode"] == \
        "device"


BAD_PAYLOADS = {
    "no-version": {"entries": {}},
    "unknown-kernel": {"schema_version": SCHEMA_VERSION,
                       "entries": {"H800": {"not_a_kernel": {}}}},
    "bad-record": {"schema_version": SCHEMA_VERSION,
                   "entries": {"H800": {"ssm_scan": {"b": {"size": 1}}}}},
    "bad-time": {"schema_version": SCHEMA_VERSION, "entries": {"H800": {
        "ssm_scan": {"b": dict(_rec("repro_torch").__dict__,
                               time_s=-1.0)}}}},
    "bad-mode": {"schema_version": SCHEMA_VERSION, "entries": {"H800": {
        "ssm_scan": {"b": dict(_rec("repro_torch").__dict__,
                               mode="guess")}}}},
    "unknown-type": {"schema_version": SCHEMA_VERSION, "entries": {"TPUv4": {
        "ssm_scan": {"b": dict(_rec("repro_torch").__dict__)}}}},
    "future": {"schema_version": SCHEMA_VERSION + 1, "entries": {}},
}


@pytest.mark.parametrize("case", sorted(BAD_PAYLOADS))
def test_version_and_schema_errors_equal_the_reference(case):
    raised = []
    for pkg in PKGS:
        cdb = mod(pkg, "autotune.costdb")
        with pytest.raises((cdb.CostDBSchemaError,
                            cdb.CostDBVersionError)) as e:
            cdb.CostDB.from_json(json.loads(json.dumps(BAD_PAYLOADS[case])))
        raised.append(type(e.value).__name__)
    assert raised[0] == raised[1]


def test_merge_of_another_version_raises():
    with pytest.raises(CostDBVersionError):
        CostDB().merge(CostDB(schema_version=SCHEMA_VERSION + 1))


def _interpolated(pkg):
    db = mod(pkg, "autotune.costdb").CostDB()
    for name, size, t in (("s1k", 1024, 1e-3), ("s4k", 4096, 9e-3),
                          ("s16k", 16384, 1.2e-1)):
        db.put("H800", "flash_attention", name,
               _rec(pkg, size=size, time_s=t))
    sizes = [512, 1024, 1500, 2048, 4096, 6000, 10000, 16384, 30000]
    return ([db.interpolated_time("H800", "flash_attention", s)
             for s in sizes],
            db.interpolated_time("H800", "decode_attention", 4096),
            [db.best_config("H800", "flash_attention", s)
             for s in (None, 700, 5000)],
            db.describe())


def test_interpolation_equals_the_reference():
    ref, port = _interpolated("repro"), _interpolated("repro_torch")
    assert port == ref
    times = port[0]
    assert all(b > a for a, b in zip(times, times[1:]))
    assert port[1] is None


# -------------------------------------------------------- MeasuredCostModel
def _factors(pkg, provider):
    profiles = mod(pkg, "core.cluster").PROFILES
    return {name: [getattr(provider, f)(p) for f in (
        "train_mfu", "prefill_mfu", "decode_compute_eff",
        "decode_engine_eff", "hbm_eff")] for name, p in profiles.items()}


def _plan(pkg, provider):
    spec = mod(pkg, "core.model_spec").PAPER_MODELS["1.5B"]
    cluster = mod(pkg, "core.cluster").paper_heterogeneous(8, 8)
    return mod(pkg, "core.scheduler").schedule(spec, cluster,
                                               cost_provider=provider)


@pytest.mark.parametrize("writer", PKGS)
def test_measured_model_and_plans_equal_the_reference(writer, tmp_path,
                                                      monkeypatch):
    """Both packages load one CostDB file (the reference's tiny sweep or
    the port's) and derive the same factors and the same 1.5B plan."""
    db = (_ref_sweep(monkeypatch) if writer == "repro" else _port_sweep())
    path = tmp_path / "db.json"
    db.save(path)
    out = {}
    for pkg in PKGS:
        loaded = mod(pkg, "autotune.costdb").CostDB.load(path)
        model = mod(pkg, "autotune.measured").MeasuredCostModel(loaded)
        out[pkg] = plain((_factors(pkg, model), _plan(pkg, model),
                          model.efficiency_table()))
    assert out["repro_torch"] == out["repro"]
    ana = mod("repro_torch", "core.cost_model").ANALYTIC
    prof = mod("repro_torch", "core.cluster").PROFILES["H20"]
    assert out["repro"][0]["H20"][1] != ana.prefill_mfu(prof)


def test_empty_db_gives_the_analytic_plan():
    ana = mod("repro_torch", "core.cost_model").ANALYTIC
    empty = MeasuredCostModel(CostDB())
    assert _factors("repro_torch", empty) == _factors("repro_torch", ana)
    assert plain(_plan("repro_torch", empty)) == \
        plain(_plan("repro_torch", ana)) == plain(_plan("repro", None))


def test_card_fractions_of_its_own_peak():
    db = CostDB()
    db.put("H100", "flash_attention", "b",
           _rec("repro_torch", time_s=1e-4, mode="device",
                config={"rows": 128, "keys": 64}))
    db.put("H100", "paged_attention", "b",
           _rec("repro_torch", time_s=2e-4, mode="device"))
    got = card_fractions(db, "H100")
    assert got == {"prefill_mfu": 3.5e10 / (1e-4 * 989e12),
                   "hbm_eff": 3e8 / (2e-4 * 3.35e12)}
    # the scheduler's profiles are priced from their own records only
    model = MeasuredCostModel(db)
    assert _factors("repro_torch", model) == _factors(
        "repro_torch", mod("repro_torch", "core.cost_model").ANALYTIC)


# ------------------------------------------------------------ the estimate
@pytest.mark.parametrize("kernel", sorted(SPACES))
@pytest.mark.parametrize("owner", PKGS)
def test_estimate_time_equals_the_reference(kernel, owner):
    """The port's estimate is the reference's formula and priors: on the
    same space (either package's), profile and ratio, the same seconds."""
    space = mod(owner, "autotune.space").SPACES[kernel]
    for shape in space.buckets() + space.buckets(tiny=True):
        for cfg in space.configs():
            for dt in ("H800", "H20"):
                got = bench.estimate_time(
                    space, shape, cfg,
                    mod("repro_torch", "core.cluster").PROFILES[dt], 1.346)
                want = ref_bench.estimate_time(
                    space, shape, cfg,
                    mod("repro", "core.cluster").PROFILES[dt], 1.346)
                assert got == want


def test_sweep_types_and_estimates():
    db = _port_sweep()
    assert db.device_types() == ["H20", "H800"]
    for dt in db.device_types():
        for kernel, space in SPACES.items():
            (name, rec), = db.records(dt, kernel).items()
            assert name == space.buckets(tiny=True)[0].name
            assert rec.mode == "interpret" and rec.configs_tried <= 8
            assert rec.flops == space.flops(space.buckets(tiny=True)[0],
                                            rec.best_config)
    with pytest.raises(KeyError, match="H100"):
        _port_sweep(device_types=["H100"])     # no card here, no profile
    with pytest.raises(KeyError, match="warp_drive"):
        _port_sweep(kernels=["warp_drive"])


def test_flop_calibration_runs_each_wrapper_on_the_cpu():
    for kernel in SPACES:
        assert bench.flop_calibration(kernel, torch.device("cpu")) == 1.0


# --------------------------------------------------------------- tuning API
def test_builtin_defaults_name_the_knobs_the_wrappers_read():
    assert tuning.BUILTIN_DEFAULTS == {
        "flash_attention": {},
        "decode_attention": {"min_split_tiles": decode_ops.MIN_SPLIT_TILES},
        "paged_attention": {"page_size": 128,
                            "min_split_tiles": decode_ops.MIN_SPLIT_TILES},
        "ssm_scan": {"chunk": scan_ops.MAX_CHUNK},
    }
    assert tuning.COMPILED["flash_attention"] == tuple(
        {"rows": rows, "keys": keys}
        for rows, keys in (flash_ops.TILES["wgmma"],
                           flash_ops.TILES["tf32x3"]))
    assert tuning.RANGES[("ssm_scan", "chunk")] == (1, scan_ops.MAX_CHUNK)


def test_register_resolve_clear_override(clean_tuning):
    tuning.register_tuned("H100", "decode_attention", {"min_split_tiles": 16})
    tuning.register_tuned("H100", "flash_attention", {"rows": 128,
                                                      "keys": 64})
    with tuning.override_device_type("H100"):
        assert tuning.tuned_config("decode_attention") == {
            "min_split_tiles": 16}
        assert tuning.resolve("decode_attention", "min_split_tiles",
                              None) == 16
        assert tuning.resolve("decode_attention", "min_split_tiles", 2) == 2
        assert tuning.tuned_config("flash_attention") == {}
        with tuning.override_device_type("H800"):
            assert tuning.resolve("decode_attention", "min_split_tiles",
                                  None) == 8
        tuning.clear_tuned()
        assert tuning.resolve("decode_attention", "min_split_tiles",
                              None) == 8
    assert tuning.current_device_type() is None       # no card here


@pytest.mark.parametrize("config", [{"rows": 64, "keys": 32}, {"keys": 32},
                                    {"rows": 128, "keys": 64}])
def test_a_record_may_name_either_k1_kernels_tiles(config, clean_tuning):
    """A CostDB record of K1 naming the float32 kernel's compiled tiles
    is read as one naming the bf16 kernel's: accepted, no knob tuned."""
    tuning.register_tuned("H100", "flash_attention", config)
    with tuning.override_device_type("H100"):
        assert tuning.tuned_config("flash_attention") == {}


@pytest.mark.parametrize("kernel,config,error", [
    ("flash_attention", {"block_q": 128}, KeyError),      # a TPU knob
    ("decode_attention", {"block_c": 512}, KeyError),
    ("warp_drive", {"chunk": 64}, KeyError),
    ("ssm_scan", {"chunk": 128}, ValueError),             # above MAX_CHUNK
    ("ssm_scan", {"chunk": 0}, ValueError),
    ("decode_attention", {"min_split_tiles": 0}, ValueError),
    ("paged_attention", {"page_size": 0}, ValueError),
    ("flash_attention", {"rows": 64, "keys": 64}, ValueError),
    ("flash_attention", {"rows": 128, "keys": 32}, ValueError),  # mixed sets
])
def test_register_tuned_refuses(kernel, config, error, clean_tuning):
    with pytest.raises(error):
        tuning.register_tuned("H100", kernel, config)
    assert tuning._TUNED == {}


def test_a_tpu_costdb_configures_nothing(clean_tuning):
    db = RefCostDB()
    db.put("TPUv5e", "ssm_scan", "b", _rec("repro", config={"chunk": 128}))
    with pytest.raises(ValueError):
        load_tuned_defaults(CostDB.from_json(db.to_json()))
    db = RefCostDB()
    db.put("TPUv5e", "flash_attention", "b",
           _rec("repro", config={"block_q": 256, "block_k": 128}))
    with pytest.raises(KeyError):
        load_tuned_defaults(CostDB.from_json(db.to_json()))


# ---------------------------------------------------- knobs into the launch
SPLIT_SHAPES = [(B, H, Hkv, D, C)
                for B, (H, Hkv), D, C in itertools.product(
                    (1, 8, 32, 64), ((12, 2), (28, 4), (64, 4), (8, 8)),
                    (64, 80, 128), (1, 33, 161, 2048, 8192))]


def _resident(body, D):
    """Blocks an SM holds: the H100's table for the tensor-core body, a
    number for the CUDA-core one."""
    return decode_ops._h100_resident(D) if body == "mma" else (lambda gc: 3)


def test_empty_table_launches_as_before(clean_tuning):
    """With no tuned table the wrappers' split counts are the builtin
    rule's at its default knob (8 tiles a split at least)."""
    with tuning.override_device_type("H100"):
        for B, H, Hkv, D, C in SPLIT_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                body = decode_ops._decode_body(dtype, D, True)
                res = _resident(body, D)
                assert decode_ops._launch_splits(
                    B, H, Hkv, D, C, 132, res, body=body) == \
                    decode_ops._launch_splits(B, H, Hkv, D, C, 132, res, 8,
                                              body)
                for page in (16, 128):
                    maxp = -(-C // page)
                    assert paged_ops._paged_splits(
                        B, Hkv, D, maxp, page, None, 132, res, H // Hkv,
                        body=body) == paged_ops._paged_splits(
                            B, Hkv, D, maxp, page, None, 132, res,
                            H // Hkv, 8, body)
        assert tuning.resolve("ssm_scan", "chunk", None) == 64
        assert tuning.resolve("paged_attention", "page_size", None) == 128


def test_tuned_defaults_flow_into_the_wrappers(clean_tuning, monkeypatch):
    db = CostDB()
    for kernel, cfg in (("decode_attention", {"min_split_tiles": 64}),
                        ("paged_attention", {"min_split_tiles": 32,
                                             "page_size": 16}),
                        ("ssm_scan", {"chunk": 16}),
                        ("flash_attention", {"rows": 128, "keys": 64})):
        db.put("H100", kernel, "b", _rec("repro_torch", mode="device",
                                         config=cfg))
        db.put("H800", kernel, "b", _rec("repro_torch", config=cfg))
    assert load_tuned_defaults(db) == 8
    B, H, Hkv, D, C = 1, 12, 2, 128, 1008
    res = decode_ops._h100_resident(D)
    # the builtin rule's counts at the default knob
    assert decode_ops._launch_splits(B, H, Hkv, D, C, 132, res, 8) == 4
    assert paged_ops._paged_splits(B, Hkv, D, C // 16, 16, None, 132, res,
                                   6, 8) == 4
    with tuning.override_device_type("H100"):
        assert tuning.tuned_config("paged_attention") == {
            "min_split_tiles": 32, "page_size": 16}
        # the split counts the wrappers would launch with: 1 where the
        # builtin rule takes 4
        assert decode_ops._launch_splits(B, H, Hkv, D, C, 132, res) == 1
        assert paged_ops._paged_splits(B, Hkv, D, C // 16, 16, None, 132,
                                       res, 6) == 1
        # the scan's chunk and the pool's page on CPU tensors
        seen = []
        real = scan_ops.mlstm_chunkwise_ref
        monkeypatch.setattr(scan_ops, "mlstm_chunkwise_ref",
                            lambda *a: seen.append(a[5]) or real(*a))
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 40, 2, 8, generator=gen) for _ in "qkv")
        ig, fg = (torch.randn(1, 40, 2, generator=gen) for _ in "if")
        scan_ops.mlstm_scan(q, k, v, ig, fg)
        assert seen == [16]
        from repro_torch.serve.kv_cache import PagedKVCache
        from repro_torch.configs import get_smoke_config
        cache = PagedKVCache(get_smoke_config("qwen-distill-1.5b"),
                             max_slots=2, max_len=64, device="cpu")
        assert cache.page == 16
    with tuning.override_device_type(None):
        assert tuning.tuned_config("ssm_scan") == {"chunk": 64}


@pytest.mark.parametrize("kernel", sorted(SPACES))
def test_every_config_names_only_the_wrappers_knobs(kernel, clean_tuning):
    """Each config of a space is one the tuning table takes, and the
    configs give the launches different parameters."""
    space = SPACES[kernel]
    params = {shape.name: set() for shape in space.buckets()}
    for cfg in space.configs():
        tuning.register_tuned("H100", kernel, cfg)
        for shape in space.buckets():
            assert space.feasible(shape, cfg, "H100")
            if kernel == "ssm_scan":
                params[shape.name].add(space._chunks(shape, cfg))
            elif kernel == "paged_attention":
                params[shape.name].add((space.n_split(shape, cfg),
                                        cfg["page_size"]))
            elif kernel == "decode_attention":
                params[shape.name].add(space.n_split(shape, cfg))
    most = max(len(p) for p in params.values())
    if kernel == "flash_attention":
        assert len(space.configs()) == 1          # compile-time tiles
    elif kernel == "ssm_scan":
        assert most == len(space.configs())       # a chunk count each
    else:
        assert most > 1                           # split counts differ


@pytest.mark.parametrize("kernel", sorted(SPACES))
def test_configs_launch_through_the_wrappers_on_cpu(kernel):
    """Each tiny config runs through ``bench.launch`` at the micro shape
    (the plain version on the CPU) and agrees with ``bench.plain``."""
    shape = bench._MICRO_SHAPES[kernel]
    for cfg in SPACES[kernel].configs(tiny=True):
        cfg = dict(cfg)
        if kernel == "paged_attention":
            cfg["page_size"] = min(cfg["page_size"], 16)
        args = bench.kernel_case(kernel, shape, cfg, torch.device("cpu"))
        got = bench.launch(kernel, cfg, args)
        want = bench.plain(kernel, cfg, args)
        assert got.shape == want.shape
        assert torch.equal(got, want)


# --------------------------------------------------------------------- CLI
def test_cli_sweep_and_validate(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = tmp_path / "db.json"
    sweep = subprocess.run(
        [sys.executable, "-m", "repro_torch.autotune", "sweep", "--tiny",
         "--device", "cpu", "--emit-costdb", str(path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert sweep.returncode == 0, sweep.stderr
    assert "prefill_mfu" in sweep.stdout
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.autotune", "validate",
         str(path)], env=env, capture_output=True, text=True, timeout=120)
    assert val.returncode == 0, val.stderr
    assert "8 records over ['H20', 'H800']" in val.stdout
    # the reference reads the port's file and writes it back unchanged
    back = tmp_path / "back.json"
    RefCostDB.load(path).save(back)
    assert back.read_bytes() == path.read_bytes()
    empty = tmp_path / "empty.json"
    CostDB().save(empty)
    assert subprocess.run(
        [sys.executable, "-m", "repro_torch.autotune", "validate",
         str(empty)], env=env, capture_output=True, text=True,
        timeout=120).returncode == 1


@pytest.mark.parametrize("one_split_faster", [False, True])
def test_device_mode_treats_equal_launches_as_one(one_split_faster,
                                                  monkeypatch):
    """Configs that launch the same split count are one candidate, timed
    as the median of their times and represented by the config nearest
    the builtin default: K3 at B 8, C 1024 splits in 4 for
    min_split_tiles 1..16 (the default, 8, stands for them) and in 1 for
    32..64 (32 stands for them)."""
    shape = port_space.ShapeBucket.make("b8_c1024", B=8, C=1024, H=12,
                                        Hkv=2, D=128)
    space = SPACES["decode_attention"]
    keys = {c["min_split_tiles"]: space.launch_key(shape, c)
            for c in space.configs()}
    assert keys == {m: ((4 if m <= 16 else 1), None)
                    for m in (1, 2, 4, 8, 16, 32, 64)}
    # noisy times: within a launch, the fastest trial is never the default
    noise = {1: 0.90, 2: 1.00, 4: 1.02, 8: 1.05, 16: 0.97, 32: 1.10,
             64: 1.01}
    fast, slow = (1.0, 1.3) if one_split_faster else (1.3, 1.0)
    calls = []
    monkeypatch.setattr(bench, "on_device_type", lambda dev: "H100")
    monkeypatch.setattr(bench, "kernel_case", lambda *a, **k: ())
    monkeypatch.setattr(bench, "launch",
                        lambda kernel, cfg, args: calls.append(cfg))

    def timer(fn, flush):
        fn()
        m = calls[-1]["min_split_tiles"]
        return noise[m] * (fast if m >= 32 else slow)

    monkeypatch.setattr(bench, "time_on_device", timer)
    monkeypatch.setattr(bench, "warm_card", lambda fn: None)
    monkeypatch.setattr(bench, "FLUSH_BYTES", 16)
    trials = []
    best = bench.bench_shape("decode_attention", shape, ["H100", "H800"],
                             device=torch.device("cpu"), trials=trials)
    assert len(trials) == 7 and best["H100"].mode == "device"
    want = 32 if one_split_faster else 8
    assert best["H100"].config == {"min_split_tiles": want}
    members = [noise[m] * (fast if m >= 32 else slow) for m in noise
               if (m >= 32) == one_split_faster]
    assert best["H100"].time_s == statistics.median(members)
    assert best["H800"].mode == "interpret"
