"""The serving function's CUDA graph of the encoder half
(``engine/export.py::make_serving_fn``), on a card at the tiny config: the
replayed requests give the eager requests' bits, whole and micro-batched;
the graph counters and the kernels' launch counters advance as the module's
docstring says, and a profiled replay runs the captured kernels; under a
profiler a request runs eagerly. At Swin-L's serving shape, the decoder's
attention-mask kernel launches once a decoder layer in every request and
never in the replayed encoder.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_graph.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.engine.export import ServingModule, make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.ops import (
    attention_mask, deformable_attention, window_attention,
)
from weed_instance_segmentation_tpu_torch.ops.cuda_build import captured

IN_HW, OUT_HW = (32, 48), (64, 96)
THRESHOLD = 0.0  # every slot kept: the id map and every per-slot array hold answers
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


def _model(device, dtype):
    return build_model('tiny-test', num_labels=3, dtype=dtype, device=device, seed=0)


def _raw(device, seed, batch=2):
    images = np.random.default_rng(seed).integers(0, 256, (batch, *IN_HW, 3), dtype=np.uint8)
    return torch.from_numpy(images).to(device)


def _eager(model, raw, micro_batch=0):
    """The request's answer with every half eager: the serving module called
    directly, a micro-batch at a time."""
    one = ServingModule(model, out_hw=OUT_HW, threshold=THRESHOLD)
    with torch.inference_mode():
        parts = [one(chunk) for chunk in (raw.split(micro_batch) if micro_batch else [raw])]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _assert_same_bits(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


def _counters(suffix: str) -> dict:
    """Every kernel's counter ``wistpu.<op><suffix>``, keyed by its launch
    counter's name."""
    return {name.removesuffix(suffix) + '.launches': n
            for name, n in trace.counters('wistpu.').items() if name.endswith(suffix)}


def _delta(after, before):
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_replays_give_the_eager_bits(cuda_device, dtype):
    """Three distinct batches in turn, the first request of the shape
    capturing: every result array of every request has the eager bits."""
    model = _model(cuda_device, dtype)
    batches = [_raw(cuda_device, seed) for seed in range(3)]
    want = [_eager(model, raw) for raw in batches]
    assert int(want[0]['valid'].sum()) >= 1
    serve = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)
    for i in (0, 1, 2, 0, 1, 2, 2):
        _assert_same_bits(serve(batches[i]), want[i])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_micro_batched_replays_give_the_eager_bits(cuda_device, dtype):
    """Batch 4 in micro-batches of 2 gives the eager micro-batched request's
    bits: each replay's outputs are read by the previous micro-batch's
    decoder before the next replay rewrites them. (One eager pass of the
    whole batch is no reference: at float32 its scores differ from two
    eager passes of 2 in their last bits, and masks flip with them.)"""
    model = _model(cuda_device, dtype)
    batches = [_raw(cuda_device, seed, batch=4) for seed in range(3)]
    want = [_eager(model, raw, micro_batch=2) for raw in batches]
    serve = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD, micro_batch=2)
    captures = trace.counter('serve.graph.captures')
    replays = trace.counter('serve.graph.replays')
    for i in (0, 1, 2, 0):
        _assert_same_bits(serve(batches[i]), want[i])
    # one capture, by the first micro-batch; every micro-batch replayed
    assert trace.counter('serve.graph.captures') == captures + 1
    assert trace.counter('serve.graph.replays') == replays + 8


@pytest.mark.cuda
def test_counters_count_where_kernels_launch(cuda_device):
    """The first request captures once: its warm-up and its decoder half
    launch what an eager request launches, and the capture records the
    encoder's kernels under their ``.captured`` counters. Every request
    replays once; after the first, its own launches (the decoder half's)
    and its replay's captured launches add up to an eager request's."""
    model = _model(cuda_device, torch.bfloat16)
    raw = _raw(cuda_device, 0)
    before = _counters('.launches')
    _eager(model, raw)
    torch.cuda.synchronize()
    eager = _delta(_counters('.launches'), before)
    encoder = {window_attention.LAUNCHES: sum(model.config.backbone_config.depths),
               deformable_attention.LAUNCHES: model.config.encoder_layers}
    assert {k: eager[k] for k in encoder} == encoder

    serve = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)
    captures, replays = trace.counter('serve.graph.captures'), trace.counter('serve.graph.replays')
    held = _counters('.captured')
    for i in range(4):
        before = _counters('.launches')
        serve(raw)
        torch.cuda.synchronize()
        launched = _delta(_counters('.launches'), before)
        assert trace.counter('serve.graph.captures') == captures + 1
        assert trace.counter('serve.graph.replays') == replays + i + 1
        if i == 0:
            assert launched == eager
            graph = _delta(_counters('.captured'), held)
            assert graph == encoder
        else:
            assert {k: launched.get(k, 0) + graph.get(k, 0) for k in eager} == eager, i
    assert _delta(_counters('.captured'), held) == encoder
    assert captured(window_attention.LAUNCHES) == 'wistpu.window_attention_fwd.captured'


def _kernel_names(fn, path) -> list:
    """The names of the device kernels that one call of ``fn`` runs, from a
    ``torch.profiler`` trace."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e['name'] for e in events if e.get('ph') == 'X' and e.get('cat') == 'kernel']


@pytest.mark.cuda
def test_a_profiled_replay_runs_the_captured_kernels(cuda_device, tmp_path):
    """A replay called through the serving function's ``graphs``, under a
    profiler, runs each hand-written encoder kernel as often as the capture
    recorded it, and gives the eager encoder's outputs."""
    model = _model(cuda_device, torch.bfloat16)
    raw = _raw(cuda_device, 0)
    serve = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)
    held = _counters('.captured')
    serve(raw)
    graph = _delta(_counters('.captured'), held)
    (key, replay), = serve.graphs.items()
    assert key == (tuple(raw.shape), raw.dtype, raw.device)
    kernels = _kernel_names(lambda: replay(raw), tmp_path / 'replay.json')
    assert sum('window_attention_fwd' in k for k in kernels) == graph[window_attention.LAUNCHES]
    assert sum('msda_fwd_kernel' in k for k in kernels) == graph[deformable_attention.LAUNCHES]
    mask_features, multi_scale = replay(raw)
    with torch.inference_mode():
        want_features, want_scales = ServingModule(model, out_hw=OUT_HW).encode(raw)
    for got, want in zip((mask_features, *multi_scale), (want_features, *want_scales)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_under_a_profiler_a_request_runs_eagerly(cuda_device):
    """A request under ``torch.profiler`` records its kernels' operator
    ranges and makes no replay; the next request outside replays again."""
    model = _model(cuda_device, torch.bfloat16)
    raw = _raw(cuda_device, 0)
    want = _eager(model, raw)
    serve = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)
    serve(raw)  # the capture
    replays = trace.counter('serve.graph.replays')
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got = serve(raw)
        torch.cuda.synchronize()
    assert trace.counter('serve.graph.replays') == replays
    names = {e.key for e in prof.key_averages()}
    assert {'wistpu::window_attention_fwd', 'wistpu::msda_fwd', 'serve.preprocess',
            'model.backbone', 'model.pixel_decoder'} <= names
    _assert_same_bits(got, want)
    _assert_same_bits(serve(raw), want)
    assert trace.counter('serve.graph.replays') == replays + 1


@pytest.mark.cuda
def test_attention_mask_launches_ten_a_swin_l_request_and_none_in_a_replay(cuda_device):
    """Swin-L at 800², batch 4, bf16: an eager request and each request
    through the serving function (the first capturing) launch the
    attention-mask kernel once for each of the 10 masks the decoder
    predicts; the capture records none, and a replay of the encoder graph
    launches none."""
    model = build_model('swin-large', num_labels=5, dtype=torch.bfloat16, device=cuda_device,
                        seed=0)
    layers = model.config.decoder_layers
    assert layers == 10
    g = torch.Generator(device=cuda_device).manual_seed(0)
    raw = torch.randint(0, 256, (4, 1024, 1024, 3), generator=g, device=cuda_device,
                        dtype=torch.uint8)
    launches, held = (trace.counter(attention_mask.LAUNCHES),
                      trace.counter(captured(attention_mask.LAUNCHES)))
    with torch.inference_mode():
        ServingModule(model, out_hw=(800, 800), emit_masks=False)(raw)
    assert trace.counter(attention_mask.LAUNCHES) - launches == layers
    serve = make_serving_fn(model, out_hw=(800, 800), micro_batch=4, emit_masks=False)
    for _ in range(2):
        launches = trace.counter(attention_mask.LAUNCHES)
        serve(raw)
        torch.cuda.synchronize()
        assert trace.counter(attention_mask.LAUNCHES) - launches == layers
    assert trace.counter(captured(attention_mask.LAUNCHES)) == held
    (replay,) = serve.graphs.values()
    launches = trace.counter(attention_mask.LAUNCHES)
    replay(raw)
    torch.cuda.synchronize()
    assert trace.counter(attention_mask.LAUNCHES) == launches
