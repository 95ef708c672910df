"""The port's perf-regression harness (``repro_torch.obs.regress`` and the
``python -m repro_torch.obs`` CLI) against the reference's: the cases of
``tests/test_regress.py`` that belong to ``regress`` run on both packages,
and both give equal reports over the same payloads (the committed
``benchmarks/baselines`` and perturbed copies of them)."""
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
PKGS = ("repro", "repro_torch")


@pytest.fixture(params=PKGS)
def rg(request):
    return importlib.import_module(f"{request.param}.obs.regress")


PAYLOAD = {
    "name": "fig_demo",
    "rows": ["alloc,120,throughput=42608 tok/s ratio=1.16x",
             "swap,15,stall_s=0.35"],
    "token_identical": True,
    "g_eff": 0.87,
    "steps": 12,
}


def _write_payload(dirpath, payload):
    p = dirpath / f"BENCH_{payload['name']}.json"
    p.write_text(json.dumps(payload))
    return p


def _dirs(tmp_path):
    basedir, rundir = tmp_path / "base", tmp_path / "run"
    basedir.mkdir(), rundir.mkdir()
    return basedir, rundir


# ============================================================== extraction
def test_extract_metrics_from_rows_and_fields(rg):
    m = rg.extract_metrics(PAYLOAD)
    assert m["alloc/throughput"] == pytest.approx(42608.0)
    assert m["alloc/ratio"] == pytest.approx(1.16)
    assert m["swap/stall_s"] == pytest.approx(0.35)
    assert m["token_identical"] == 1.0
    assert m["g_eff"] == pytest.approx(0.87)
    assert "name" not in m


def test_direction_classification(rg):
    assert rg.classify_direction("alloc/throughput") == "higher"
    assert rg.classify_direction("e2e/tput") == "higher"
    assert rg.classify_direction("hit_rate") == "higher"
    assert rg.classify_direction("token_identical") == "higher"
    assert rg.classify_direction("swap/stall_s") == "lower"
    assert rg.classify_direction("p99/latency_s") == "lower"
    assert rg.classify_direction("buffer/dropped") == "lower"
    assert rg.classify_direction("mystery_number") == "both"
    assert rg.is_wallclock("alloc/us")
    assert rg.is_wallclock("sched/time_us")
    assert rg.is_wallclock("table5/ours")
    assert not rg.is_wallclock("alloc/throughput")


def test_compare_metrics_direction_aware(rg):
    base = {"a/throughput": 100.0, "a/latency": 1.0, "a/other": 5.0}
    up = rg.compare_metrics(base, {"a/throughput": 120.0, "a/latency": 0.5,
                                   "a/other": 5.0}, tol=0.05)
    assert [c["status"] for c in up] == ["improved", "ok", "improved"]
    down = rg.compare_metrics(base, {"a/throughput": 80.0, "a/latency": 2.0,
                                     "a/other": 5.0}, tol=0.05)
    assert [c["status"] for c in down] == ["regressed", "ok", "regressed"]
    ok = rg.compare_metrics(base, {"a/throughput": 97.0, "a/latency": 1.04,
                                   "a/other": 5.2}, tol=0.05)
    assert [c["status"] for c in ok] == ["ok", "ok", "ok"]
    missing = rg.compare_metrics(base, {"a/throughput": 100.0}, tol=0.05)
    assert {c["status"] for c in missing} == {"ok", "missing"}
    wc = rg.compare_metrics({"a/stall_s": 1.0}, {"a/stall_s": 9.0},
                            tol=0.05)
    assert [c["status"] for c in wc] == ["skipped"]
    wc = rg.compare_metrics({"a/stall_s": 1.0}, {"a/stall_s": 9.0},
                            tol=0.05, include_wallclock=True)
    assert [c["status"] for c in wc] == ["regressed"]


# ============================================================ compare_dirs
def test_compare_dirs_pass_and_fail(rg, tmp_path):
    basedir, rundir = _dirs(tmp_path)
    _write_payload(basedir, PAYLOAD)
    _write_payload(rundir, PAYLOAD)
    rep = rg.compare_dirs(str(basedir), str(rundir))
    assert rep["ok"] and rep["n_regressions"] == 0 and rep["n_checks"] > 0
    assert "PASS" in rg.format_report(rep)
    bad = json.loads(json.dumps(PAYLOAD))
    bad["rows"][0] = "alloc,120,throughput=25000 tok/s ratio=1.16x"
    bad["token_identical"] = False
    _write_payload(rundir, bad)
    rep = rg.compare_dirs(str(basedir), str(rundir))
    assert not rep["ok"]
    failed = {c["metric"] for p in rep["payloads"] for c in p["checks"]
              if c["status"] == "regressed"}
    assert failed == {"alloc/throughput", "token_identical"}
    assert "REGRESSION" in rg.format_report(rep)


def test_compare_dirs_missing_payload_strict(rg, tmp_path):
    basedir, rundir = _dirs(tmp_path)
    _write_payload(basedir, PAYLOAD)
    rep = rg.compare_dirs(str(basedir), str(rundir))
    assert rep["ok"] and rep["missing_payloads"] == ["fig_demo"]
    assert not rg.compare_dirs(str(basedir), str(rundir), strict=True)["ok"]


def test_wallclock_skipped_unless_requested(rg, tmp_path):
    basedir, rundir = _dirs(tmp_path)
    _write_payload(basedir, {"name": "t", "rows": ["sched,100,ours=2.1"],
                             "wall_s": 9.0})
    _write_payload(rundir, {"name": "t", "rows": ["sched,900,ours=8.4"],
                            "wall_s": 90.0})
    assert rg.compare_dirs(str(basedir), str(rundir))["ok"]
    assert not rg.compare_dirs(str(basedir), str(rundir),
                               include_wallclock=True)["ok"]


# ==================================================================== CLI
def test_regress_cli_exit_codes(rg, tmp_path, capsys):
    basedir, rundir = _dirs(tmp_path)
    _write_payload(basedir, PAYLOAD)
    _write_payload(rundir, PAYLOAD)
    assert rg.main(["--baselines", str(basedir), "--run", str(rundir)]) == 0
    bad = json.loads(json.dumps(PAYLOAD))
    bad["g_eff"] = 0.4
    _write_payload(rundir, bad)
    report_path = tmp_path / "report.json"
    capsys.readouterr()
    assert rg.main(["--baselines", str(basedir), "--run", str(rundir),
                    "--json", "--report", str(report_path)]) == 2
    assert not json.loads(capsys.readouterr().out)["ok"]
    assert json.loads(report_path.read_text())["n_regressions"] >= 1
    assert rg.main(["--baselines", str(basedir), "--run", str(rundir),
                    "--tol", "0.9"]) == 0
    assert rg.main(["--baselines", str(tmp_path / "nope"),
                    "--run", str(rundir)]) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_regress_module_dispatch(pkg):
    dispatch = importlib.import_module(f"{pkg}.obs.__main__")._dispatch
    assert dispatch(["regress", "--baselines", "/nonexistent-xyz",
                     "--run", "."]) == 2


# ==================================================== equal across packages
def _cut(payload, frac):
    """The payload with its first throughput-like metric cut by ``frac``
    (a top-level field, or a row's key=value)."""
    out = json.loads(json.dumps(payload))
    for k, v in out.items():
        if "throughput" in k and isinstance(v, (int, float)):
            out[k] = v * (1 - frac)
            return out
    for i, row in enumerate(out.get("rows", [])):
        if isinstance(row, str) and "throughput=" in row:
            head, tail = row.split("throughput=", 1)
            num = tail.split()[0].rstrip(",")
            out["rows"][i] = (head + "throughput="
                              + repr(float(num) * (1 - frac))
                              + tail[len(num):])
            return out
    return None


PERTURBATIONS = ("identical", "throughput-10pct", "one-missing", "strict",
                 "wallclock")


@pytest.mark.parametrize("case", PERTURBATIONS)
def test_reports_equal_across_packages(case, tmp_path):
    run = tmp_path / "run"
    shutil.copytree(BASELINES, run)
    kw = {}
    if case == "throughput-10pct":
        for f in sorted(run.glob("BENCH_*.json")):
            cut = _cut(json.loads(f.read_text()), 0.10)
            if cut is not None:
                f.write_text(json.dumps(cut))
                break
    elif case in ("one-missing", "strict"):
        sorted(run.glob("BENCH_*.json"))[0].unlink()
        kw["strict"] = case == "strict"
    elif case == "wallclock":
        kw["include_wallclock"] = True
    reports = []
    for pkg in PKGS:
        rg = importlib.import_module(f"{pkg}.obs.regress")
        rep = rg.compare_dirs(str(BASELINES), str(run), **kw)
        reports.append((rep, rg.format_report(rep)))
    assert reports[0] == reports[1]
    rep = reports[0][0]
    assert rep["n_payloads"] >= 1
    assert rep["ok"] == (case in ("identical", "one-missing", "wallclock"))


def test_cli_over_the_baselines(tmp_path):
    """``python -m repro_torch.obs regress``: the baselines against
    themselves exit 0, against a copy with one throughput cut by 10% exit
    2; ``python -m repro_torch.obs analyze`` reads a trace."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def obs(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.obs",
                               *map(str, args)], env=env,
                              capture_output=True, text=True, timeout=120)

    same = obs("regress", "--baselines", BASELINES, "--run", BASELINES)
    assert same.returncode == 0, same.stdout + same.stderr
    run = tmp_path / "run"
    shutil.copytree(BASELINES, run)
    f = run / "BENCH_end_to_end.json"
    f.write_text(json.dumps(_cut(json.loads(f.read_text()), 0.10)))
    cut = obs("regress", "--baselines", BASELINES, "--run", run)
    assert cut.returncode == 2, cut.stdout + cut.stderr
    assert "REGRESSION" in cut.stdout
    from repro_torch.obs import Tracer
    tr = Tracer()
    tr.span("stage", "generation", "g", 0.0, 2.0, tokens=10)
    tr.span("stage", "train", "t", 2.0, 1.0, tokens=64)
    path = tmp_path / "trace.json"
    tr.dump(str(path))
    an = obs("analyze", path, "--min-stages", 2)
    assert an.returncode == 0, an.stdout + an.stderr
