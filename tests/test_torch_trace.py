"""The port's recorder of spans and counters (``engine/trace.py``), on the
CPU: nesting, ids and parents, the ring's bound, the counters, the
profiler ranges it opens only under a profiler, the one trace a profile
writes with each span as its range, and the spans a tiny train step and a
tiny serving call record."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import make_train_collate
from weed_instance_segmentation_tpu_torch.datasets.loader import to_device
from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.engine.export import make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.engine.steps import make_optimizer, make_train_step


def _window(fn) -> list:
    """The spans this thread recorded while ``fn`` ran."""
    t0 = time.perf_counter()
    fn()
    me = threading.get_native_id()
    return [s for s in trace.spans(t0, time.perf_counter()) if s.thread == me]


def _inside(inner: trace.Span, outer: trace.Span) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_spans_nest_with_parents_and_shared_ids():
    rec = trace.Recorder()
    with rec.span('root', id=7):
        with rec.span('child'):
            with rec.span('leaf'):
                pass
        with rec.span('other', id=3):
            pass
    with rec.span('alone'):
        pass
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ['leaf', 'child', 'other', 'root', 'alone']
    assert (got['root'].parent, got['child'].parent, got['leaf'].parent) == (None, 'root', 'child')
    assert (got['root'].id, got['child'].id, got['leaf'].id, got['other'].id) == (7, 7, 7, 3)
    assert got['alone'].id is None and got['alone'].parent is None
    assert _inside(got['leaf'], got['child']) and _inside(got['child'], got['root'])
    assert {s.thread for s in got.values()} == {threading.get_native_id()}
    assert all(s.events is None and trace.device_ms(s) is None for s in got.values())
    assert rec.totals()['root'][0] == 1 and rec.totals()['root'][1] == pytest.approx(
        got['root'].seconds)


def test_thread_spans_keep_their_own_stack():
    rec = trace.Recorder()

    def work():
        with rec.span('thread.root', id=1):
            with rec.span('thread.child'):
                pass

    with rec.span('main.root', id=0):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert got['thread.root'].parent is None and got['thread.child'].parent == 'thread.root'
    assert got['thread.child'].id == 1 and got['thread.child'].thread != got['main.root'].thread
    assert rec.dropped() == 0


def test_ring_is_bounded_and_counts_what_it_dropped():
    rec = trace.Recorder(capacity=4)
    for i in range(10):
        with rec.span('s', id=i):
            pass
    assert [s.id for s in rec.spans()] == [6, 7, 8, 9]
    assert rec.dropped() == 6
    assert rec.totals()['s'][0] == 10  # the totals drop nothing


def test_counters_sum_over_threads():
    name = 'test.trace.counter'
    before = trace.counter(name)
    trace.count(name)
    worker = threading.Thread(target=trace.count, args=(name, 5))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert trace.counter(name) == before + 6
    assert trace.counter('test.trace.never') == 0


def test_spans_selects_a_window():
    with trace.span('test.window.before'):
        pass
    t0 = time.perf_counter()
    with trace.span('test.window.inside'):
        pass
    t1 = time.perf_counter()
    with trace.span('test.window.after'):
        pass

    def names(spans):
        return [s.name for s in spans if s.name.startswith('test.window.')]

    assert names(trace.spans(t0, t1)) == ['test.window.inside']
    assert names(trace.spans(None, t1))[-2:] == ['test.window.before', 'test.window.inside']


def test_disabled_recorder_records_nothing():
    before = trace.totals().get('test.disabled', (0, 0.0))
    trace.enable(False)
    try:
        with trace.span('test.disabled'):
            pass
    finally:
        trace.enable(True)
    assert trace.totals().get('test.disabled', (0, 0.0)) == before
    assert not [s for s in trace.spans() if s.name == 'test.disabled']


def test_ranges_open_only_under_a_profiler(monkeypatch):
    """No ``record_function`` call with no profiler running; under one, the
    trace holds a range of each span's name."""
    opened = []
    original = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return original(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', counting)
    with trace.span('test.range.outer'):
        with trace.span('test.range.inner'):
            torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span('test.range.outer'):
            with trace.span('test.range.inner'):
                torch.ones(4).sum()
    assert opened == ['test.range.outer', 'test.range.inner']
    names = {e.key for e in prof.key_averages()}
    assert {'test.range.outer', 'test.range.inner'} <= names


def test_profile_holds_each_span_as_its_range(tmp_path):
    """``stop_profile`` writes one trace in which each of 120 spans is a
    ``user_annotation`` range of its name, each inner range inside an outer
    one, and no file beside it."""
    profile = trace.start_profile(torch.device('cpu'))
    for i in range(60):
        with trace.span('test.twin.outer', id=i):
            with trace.span('test.twin.inner'):
                torch.ones(64).cumsum(0)
    assert trace.stop_profile(profile, str(tmp_path)) is None  # no device work on the CPU
    assert sorted(p.name for p in tmp_path.iterdir()) == ['trace.json']
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    ranges = {}
    for e in events:
        if e.get('ph') == 'X' and e['name'].startswith('test.twin.'):
            assert e['cat'] == 'user_annotation', e
            ranges.setdefault(e['name'], []).append((e['ts'], e['ts'] + e['dur']))
    outer, inner = ranges['test.twin.outer'], ranges['test.twin.inner']
    assert len(outer) == len(inner) == 60
    for a, b in inner:
        assert any(c <= a and b <= d for c, d in outer), (a, b)


def test_device_busy_fraction(tmp_path):
    """The busy share merges overlapping device intervals over the trace's
    span."""
    events = {'traceEvents': [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'a', 'ts': 0, 'dur': 100},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 10, 'dur': 20},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 20, 'dur': 20},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'c', 'ts': 70, 'dur': 10}]}
    path = tmp_path / 'synthetic.json'
    path.write_text(json.dumps(events))
    assert trace.device_busy_fraction(str(path)) == pytest.approx(0.4)
    assert trace.busy_fraction(events['traceEvents'][:1]) is None


def test_train_step_records_its_layers():
    """A tiny train step: ``train.micro_step`` holds ``forward`` (the
    model's spans in it), ``criterion`` (the LAP's wait and solve in it),
    ``backward`` and ``optimizer``, all with the micro-step's index."""
    model = build_model('tiny-test', num_labels=3, device='cpu', seed=0, train=True)
    step = make_train_step(model, model.config, make_optimizer(model.parameters(), 5e-5))
    sample = {'pixel_values': np.zeros((3, 64, 64), np.float32),
              'mask_labels': np.ones((1, 64, 64), np.uint8), 'class_labels': np.zeros(1, np.int64)}
    batch = to_device(make_train_collate((64, 64), 2, 1)([sample]), 'cpu')
    step(batch)
    spans = _window(lambda: step(batch))
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (root,) = by_name['train.micro_step']
    assert root.id == 1 and root.parent is None
    for name, parent in (('forward', 'train.micro_step'), ('criterion', 'train.micro_step'),
                         ('backward', 'train.micro_step'), ('optimizer', 'train.micro_step'),
                         ('model.backbone', 'forward'), ('model.pixel_decoder', 'forward'),
                         ('model.decoder', 'forward'), ('model.msda', 'model.pixel_decoder'),
                         ('lap.bubble', 'criterion'), ('lap.wait', 'lap.bubble'),
                         ('lap.solve', 'lap.bubble')):
        assert by_name[name], name
        for s in by_name[name]:
            assert s.parent == parent and s.id == 1 and _inside(s, root), (name, s)
    (crit,) = by_name['criterion']
    assert all(_inside(s, crit) for s in by_name['lap.wait'] + by_name['lap.solve'])


def test_serving_call_records_its_layers():
    """A tiny serving call: ``serve.request`` (its id the call's index)
    holds the pre-process, the model's spans and the post-process."""
    model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    serve = make_serving_fn(model, out_hw=(64, 64), threshold=0.0)
    raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3),
                                                             dtype=np.uint8))
    serve(raw)
    spans = _window(lambda: serve(raw))
    (root,) = [s for s in spans if s.name == 'serve.request']
    assert root.id == 1 and root.parent is None
    parents = {s.name: s.parent for s in spans if s is not root}
    assert parents == {'serve.preprocess': 'serve.request', 'model.backbone': 'serve.request',
                       'model.pixel_decoder': 'serve.request', 'model.msda': 'model.pixel_decoder',
                       'model.decoder': 'serve.request', 'serve.postprocess': 'serve.request'}
    assert all(s.id == 1 and _inside(s, root) for s in spans)
    order = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == 'serve.request']
    assert order == ['serve.preprocess', 'model.backbone', 'model.pixel_decoder', 'model.decoder',
                     'serve.postprocess']
