"""The port's trace recorder (``repro_torch.obs.Tracer``) on the CPU.

The same events recorded by the port's tracer and the reference's
``repro.obs.trace.Tracer`` export the same Chrome-trace dict; the export
round-trips through its JSON file; begin/end nest and an unmatched end
raises, as ``tests/test_obs.py`` holds the reference.  A tracer changes
nothing it observes: ``PagedEngine``'s greedy tokens and log-probs and a
trainer step's rollouts, loss and updated parameters are bit-identical
with and without one.
"""
import json

import pytest
import torch

from repro.obs.trace import Tracer as JaxTracer
from repro_torch.configs import get_smoke_config
from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
from repro_torch.models import transformer
from repro_torch.models.api import ModelConfig
from repro_torch.obs import TraceError, Tracer
from repro_torch.rl.async_trainer import AsyncGRPOTrainer, TrainerConfig
from repro_torch.rl.rollout import GenConfig
from repro_torch.rl.weight_sync import WeightStore
from repro_torch.serve import PagedEngine, ServeConfig

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=Tokenizer().vocab_size,
            dtype="float32", remat=False)


def _record(tr):
    tr.span("stage", "train", "step", 1.0, 0.5, tokens=64)
    tr.begin("engine", "loop", "step", 1.2, queued=3)
    tr.instant("stage", "sync", "publish", 1.5, version=2)
    tr.end("engine", "loop", 1.7)
    tr.counter("engine", "pages", 1.0, free=3, occupancy=0.5)
    tr.span("engine", "decode", "decode_step", 2.0, 0.25, slots=4)
    return tr


def test_tracer_chrome_export_roundtrip(tmp_path):
    tr = _record(Tracer(meta={"who": "test"}))
    p = tmp_path / "t.json"
    assert tr.dump(str(p)) == str(p)
    doc = json.loads(p.read_text())
    assert doc == tr.to_chrome()
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "B", "E", "i", "C", "M"}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["ts"] == pytest.approx(1.0e6) and x["dur"] == pytest.approx(5e5)
    assert x["args"]["tokens"] == 64
    assert doc["otherData"]["who"] == "test"
    names = {e["args"].get("name") for e in evs if e["ph"] == "M"}
    assert {"stage", "train", "sync", "engine", "loop", "pages"} <= names
    assert tr.n_events == 6
    assert list(tr.spans("engine")) == [("decode_step", 2.0, 0.25,
                                         {"slots": 4})]


def test_tracer_begin_end_nesting_and_errors():
    tr = Tracer()
    tr.begin("engine", "loop", "step", 0.0)
    tr.begin("engine", "loop", "inner", 0.1)
    assert tr.open_spans() == {("engine", "loop"): ["step", "inner"]}
    assert tr.end("engine", "loop", 0.2) == "inner"
    assert tr.end("engine", "loop", 0.3) == "step"
    assert tr.open_spans() == {}
    with pytest.raises(TraceError):
        tr.end("engine", "loop", 0.4)          # end without begin
    seen = []
    tr.add_sink(lambda *ev: seen.append(ev))
    tr.instant("stage", "sync", "publish", 0.5, version=3)
    assert seen == [("i", "stage", "sync", "publish", 0.5, 0.0,
                     {"version": 3})]
    assert 0.0 <= tr.now()


def test_same_events_same_chrome_export_as_the_reference():
    meta = {"launcher": "train"}
    assert (_record(Tracer(meta=meta)).to_chrome()
            == _record(JaxTracer(meta=meta)).to_chrome())


def _paged(tracer):
    cfg = ModelConfig(**TINY)
    store = WeightStore()
    store.publish(transformer.init(0, cfg, "cpu"))
    engine = PagedEngine(cfg, store, GenConfig(max_new_tokens=6, greedy=True),
                         ServeConfig(max_slots=4, max_len=64, page_size=8),
                         tracer=tracer, device="cpu")
    return engine.generate_groups(MathTaskGenerator(seed=5).batch(3), 2)


def test_paged_engine_tokens_do_not_depend_on_the_tracer():
    tr = Tracer()
    traced, m = _paged(tr)
    plain, _ = _paged(None)
    assert [r.completion_ids for r in traced] == \
        [r.completion_ids for r in plain]
    for a, b in zip(traced, plain):
        assert (a.behavior_logp == b.behavior_logp).all()
    assert tr.open_spans() == {}
    decode = [s for s in tr.spans("engine", "decode")]
    assert len(decode) == m["decode_steps"] > 0
    assert len(list(tr.spans("engine", "prefill"))) >= 1


def _trainer_step(tracer):
    cfg = get_smoke_config("qwen-distill-1.5b").replace(
        vocab=259, dtype="float32", remat=False)
    tr = AsyncGRPOTrainer(cfg, TrainerConfig(group_size=2, prompts_per_step=2,
                                             engine="paged", trace=tracer),
                          device="cpu")
    tr.engine.gen.greedy = True
    seen = []
    score = tr.rewarder.score_batch
    tr.rewarder.score_batch = lambda rs: (seen.extend(rs), score(rs))[1]
    hist = tr.run(1, verbose=False)
    return tr, seen, hist


def test_trainer_step_does_not_depend_on_the_tracer():
    tracer = Tracer()
    a, seen_a, hist_a = _trainer_step(tracer)
    b, seen_b, hist_b = _trainer_step(None)
    assert [r.completion_ids for r in seen_a] == \
        [r.completion_ids for r in seen_b]
    assert hist_a == hist_b
    for (name, p), (_, q) in zip(a.params.named_parameters(),
                                 b.params.named_parameters()):
        assert torch.equal(p, q), name
    stage = list(tracer.spans("stage"))
    assert [s[0] for s in stage] == ["produce", "train_step"]
    publishes = [e for e in tracer.to_chrome()["traceEvents"]
                 if e["ph"] == "i" and e["name"] == "publish"]
    assert [e["args"]["version"] for e in publishes] == [2]
    assert len(list(tracer.spans("engine", "decode"))) > 0
