"""Data-parallel and model-sharded training of the port on the CPU.

Every cross-rank case runs in one cluster of two ``gloo`` processes, each
launched as ``python tests/test_torch_parallel.py <json>``: the block under
``if __name__ == '__main__'`` runs a worker, which imports torch and the
port only, never jax. The cluster runs, in one process group:

- ``ddp``: two DDP ranks at tiny-test, 6 micro-steps with accumulation 2
  (three updates) from a process-sharded loader whose last global batch
  leaves rank 1 all padding, drop path on, a mid-cycle ``train_state/``
  after micro-step 3; ``ddp_resume``: a fresh model resumed from it;
- ``fsdp``: the same on a dp1×mp2 mesh (FSDP2 shards over 'model', both
  ranks feed every row); ``fsdp_resume`` likewise;
- ``metrics``: ``test_with_metrics`` over a process-sharded loader;
- ``engine_test``: the ``engine.test`` entry point as two processes;
- ``trainer_dp2`` / ``trainer_mp2``: ``engine.train.main()`` with
  ``DATA_PARALLEL=2`` and with ``DATA_PARALLEL=1 MODEL_PARALLEL=2``.

The tests hold them to the one-process port (itself held to the JAX step
by ``tests/test_torch_training.py``), and the per-rank loss normalisation
and the sharded loader to the JAX package directly.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the worker runs as a script
    sys.path.insert(0, REPO)

from weed_instance_segmentation_tpu_torch import config  # noqa: E402
from weed_instance_segmentation_tpu_torch.datasets import dataset_utils  # noqa: E402
from weed_instance_segmentation_tpu_torch.datasets.loader import (  # noqa: E402
    DataLoader, device_batches,
)
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt  # noqa: E402
from weed_instance_segmentation_tpu_torch.engine import metrics  # noqa: E402
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model  # noqa: E402
from weed_instance_segmentation_tpu_torch.engine.steps import (  # noqa: E402
    make_forward_fn, make_optimizer, make_train_step,
)
from weed_instance_segmentation_tpu_torch.models.swin import SwinBlock  # noqa: E402
from weed_instance_segmentation_tpu_torch.parallel import mesh as pmesh  # noqa: E402

HW = (64, 96)
LABELS = 3
GLOBAL_BATCH = 4
N_MAX = 4
TRAIN_SAMPLES = 22  # five full global batches of 4, then one of 2: rank 1 all padding
STEPS = 6
ACCUMULATION = 2
MID = 3  # the mid-cycle save point
LR = 1e-4
DROP_PATH = 0.2
EVAL_IMAGES = 5  # global batches of 4 and 1
TARGET_HW = (128, 192)
POINTS = 64  # the criterion's points in the loss-normalisation cases
CLUSTER_CASES = ('ddp', 'ddp_resume', 'fsdp', 'fsdp_resume', 'metrics', 'engine_test',
                 'trainer_dp2', 'trainer_mp2')


# ---- data and models, shared by the workers and the one-process runs ----

def train_samples(n: int = TRAIN_SAMPLES) -> list[dict]:
    """Seeded 64 x 96 samples with 1-4 rectangle instances each, so the
    ranks' matched counts differ."""
    rng = np.random.default_rng(11)
    samples = []
    for i in range(n):
        count = 1 + i % 4
        masks = np.zeros((count, *HW), np.uint8)
        for j in range(count):
            y, x = rng.integers(0, HW[0] - 16), rng.integers(0, HW[1] - 16)
            masks[j, y:y + rng.integers(6, 16), x:x + rng.integers(6, 16)] = 1
        samples.append({'pixel_values': rng.standard_normal((3, *HW)).astype(np.float32),
                        'mask_labels': masks,
                        'class_labels': rng.integers(0, LABELS, count).astype(np.int64)})
    return samples


def train_model() -> torch.nn.Module:
    model = build_model('tiny-test', num_labels=LABELS, device='cpu', train=True, seed=0)
    for block in model.modules():
        if isinstance(block, SwinBlock):
            block.drop_path_rate = DROP_PATH  # so the rank-sliced drop-path draws count
    return model


def eval_model() -> torch.nn.Module:
    return build_model('tiny-test', num_labels=LABELS, device='cpu', seed=1)


def run_training(mesh, save_dir: str | None = None, resume: str | None = None) -> tuple:
    """(losses, full state dict) of ``STEPS`` micro-steps on ``mesh`` (None:
    one process), saving a train state after micro-step ``MID`` into
    ``save_dir``, or resuming from ``resume``."""
    model = pmesh.wrap_model(train_model(), mesh, torch.device('cpu'))
    optimizer = make_optimizer(model.parameters(), LR)
    step = make_train_step(model, pmesh.unwrap(model).config, optimizer, ACCUMULATION,
                           seed=7, mesh=mesh)
    index, count = pmesh.data_coordinate(mesh)
    collate = dataset_utils.make_train_collate(HW, N_MAX, GLOBAL_BATCH // count)
    loader = DataLoader(train_samples(), GLOBAL_BATCH, collate, shuffle=True, seed=5,
                        prefetch=0, process_index=index, process_count=count)
    batches = list(device_batches(loader, torch.device('cpu')))
    assert len(batches) == STEPS
    if resume is not None:
        ckpt.load_train_checkpoint(resume, model, optimizer, step)
    losses = []
    for batch in batches[step.micro_steps:]:
        losses.append(float(step(batch)))
        if save_dir is not None and step.micro_steps == MID:
            ckpt.save_train_checkpoint(save_dir, model, optimizer, step)
    state = {name: pmesh.full_tensor(t).detach().clone()
             for name, t in pmesh.unwrap(model).state_dict().items()}
    return losses, state


def eval_loader(cache: str, process_index: int = 0, process_count: int = 1) -> DataLoader:
    return DataLoader(dataset_utils.PreprocessedDataset(cache), GLOBAL_BATCH,
                      dataset_utils.collate_fn, prefetch=0, process_index=process_index,
                      process_count=process_count)


def run_metrics(cache: str, process_index: int = 0, process_count: int = 1) -> dict:
    result = metrics.test_with_metrics(make_forward_fn(eval_model()),
                                       eval_loader(cache, process_index, process_count),
                                       threshold=0.0, device='cpu', pad_hw=HW)
    return metrics.prepare_metrics_for_json(result) or {}


def run_engine_test(caches: str) -> dict:
    """``engine.test.test_model`` on the saved eval model over the
    crop_weed-style ``Test`` cache under ``caches``, batch 4."""
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed
    from weed_instance_segmentation_tpu_torch.engine.test import test_model

    config.MODELS_OUTPUT_DIR = os.path.join(caches, 'models') + '/'
    config.DATASET_LIST = ['crop_weed']
    config.BATCH_SIZE = GLOBAL_BATCH
    config.DATA_PARALLEL = None
    crop_weed.PROCESSED_DIR = os.path.join(caches, 'crop') + '/'
    return metrics.prepare_metrics_for_json(test_model('run/best_model', device='cpu')) or {}


def trainer_settings(root: str, case: str) -> dict:
    """``engine.train``'s config for a tiny pheno_bench cache under
    ``root``: batch 2, accumulation 2, 1 epoch, from scratch."""
    return {'MODEL_CHECKPOINT': os.path.join(root, 'no-such-checkpoint'),
            'MODEL_ARCH': 'tiny-test', 'BATCH_SIZE': 2, 'GRADIENT_ACCUMULATION': 2,
            'EPOCHS': 1, 'MAX_INSTANCES': 8, 'DATASET_LIST': ['pheno_bench'],
            'MODELS_OUTPUT_DIR': os.path.join(root, case, 'models') + '/', 'RESUME': None,
            'FORCE_PREPROCESSING': False,
            'DATA_PARALLEL': 1 if case == 'trainer_mp2' else 2,
            'MODEL_PARALLEL': 2 if case == 'trainer_mp2' else None}


def tiny_cache_samples(n: int, split: str) -> list:
    """Tiny 64 x 96 samples (2 rectangles of labels 1 and 2) as a
    pheno_bench cache holds them."""
    samples = []
    for i in range(n):
        r = np.random.default_rng(300 + i + 10 * len(split))
        original = np.zeros(HW, np.int32)
        original[8:30, 10:40], original[35:60, 50:90] = 1, 2
        samples.append({'pixel_values': r.standard_normal((3, *HW)).astype(np.float32),
                        'mask_labels': np.stack([original == 1, original == 2]).astype(np.uint8),
                        'class_labels': np.asarray([1, 2]), 'target_size': HW,
                        'original_map': original, 'id_to_semantic': {1: 1, 2: 2},
                        'file_name': f'{split}_{i:03d}.png'})
    return samples


# ---- the worker ----

def _worker(spec: dict) -> None:
    torch.set_num_threads(1)
    rank, out = spec['rank'], spec['out']
    os.environ.update({'WISTPU_COORDINATOR': f'localhost:{spec["port"]}',
                       'WISTPU_NUM_PROCESSES': str(spec['world']),
                       'WISTPU_PROCESS_ID': str(rank)})
    os.environ['WISTPU_DEVICE'] = 'cpu'
    assert pmesh.maybe_initialize_distributed('cpu', timeout=timedelta(seconds=120))
    writes: list[str] = []

    def audit(event, args):  # the files and directories this rank creates
        if event == 'open' and isinstance(args[0], str) and isinstance(args[1], str) and any(
                m in args[1] for m in 'wax+'):
            writes.append(args[0])
        elif event == 'os.mkdir':
            writes.append(str(args[0]))

    sys.addaudithook(audit)
    report = {}
    for case in spec['cases']:
        if case in ('ddp', 'ddp_resume', 'fsdp', 'fsdp_resume', 'fsdp_2x2'):
            shape = {'ddp': (2, 1), 'fsdp': (1, 2), 'fsdp_2x2': (2, 2)}[case.split('_r')[0]]
            mesh = pmesh.create_mesh(*shape, device='cpu')
            kind = case.split('_r')[0]
            losses, state = run_training(
                mesh, save_dir=os.path.join(out, f'{kind}_mid') if case == kind else None,
                resume=os.path.join(out, f'{kind}_mid') if case.endswith('resume') else None)
            report[case] = losses
            if rank == 0:
                np.savez(os.path.join(out, f'{case}.npz'), **{k: v.numpy() for k, v in
                                                               state.items()})
        elif case == 'metrics':
            report[case] = run_metrics(spec['eval_cache'], rank, spec['world'])
        elif case == 'engine_test':
            report[case] = run_engine_test(os.path.dirname(spec['eval_cache']))
        elif case.startswith('trainer'):
            from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import (
                definitions as pheno_bench,
            )
            from weed_instance_segmentation_tpu_torch.engine import train

            for name, value in trainer_settings(out, case).items():
                setattr(config, name, value)
            pheno_bench.PROCESSED_DIR = spec['trainer_cache']
            writes.clear()
            train.main()
            report[case] = sorted({w for w in writes if w.startswith(os.path.join(out, case))})
    with open(os.path.join(out, f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)
    pmesh.barrier()
    torch.distributed.destroy_process_group()


# ---- the cluster and the one-process references ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch(out: str, world: int, cases: tuple, timeout: int = 240, **extra) -> list[dict]:
    """Run ``cases`` in ``world`` worker processes; their reports by rank."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), json.dumps(dict(
            rank=rank, world=world, port=port, out=out, cases=list(cases), **extra))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f'rank {rank} exited {proc.returncode}:\n{text[-6000:]}'
    reports = []
    for rank in range(world):
        with open(os.path.join(out, f'rank{rank}.json')) as f:
            reports.append(json.load(f))
    return reports


@pytest.fixture(scope='module')
def caches(tmp_path_factory):
    """The evaluation cache (ground truth from the eval model's own
    segments, so the metric lies away from 0 and 1) and a tiny pheno_bench
    cache for the trainer."""
    root = tmp_path_factory.mktemp('parallel_caches')
    model = eval_model()
    samples = []
    for i in range(EVAL_IMAGES):
        rng = np.random.default_rng(200 + i)
        pixels = rng.standard_normal((3, *HW)).astype(np.float32)
        with torch.no_grad():
            out = model(torch.from_numpy(pixels[None]))
        pred = metrics.post_process_instance_segmentation(out, threshold=0.0,
                                                          target_sizes=[TARGET_HW])[0]
        original = np.where(pred['segmentation'] >= 0, pred['segmentation'] + 1, 0)
        original = original.astype(np.int32)
        mapping = {}
        for j, info in enumerate(pred['segments_info']):
            uid = info['id'] + 1
            if j % 2:
                moved = np.roll(original == uid, 3, axis=1)
                original[original == uid] = 0
                original[moved & (original == 0)] = uid
            mapping[uid] = info['label_id'] if j % 3 else (info['label_id'] + 1) % LABELS
        samples.append({'pixel_values': pixels, 'mask_labels': np.zeros((0, *HW), np.uint8),
                        'class_labels': np.zeros(0, np.int64), 'target_size': TARGET_HW,
                        'original_map': original, 'id_to_semantic': mapping,
                        'file_name': f'eval_{i:03d}.png'})
    dataset_utils.process_and_save(samples, str(root / 'eval'))
    dataset_utils.process_and_save(samples, str(root / 'crop' / 'Test'))
    ckpt.save_pretrained(str(root / 'models' / 'run' / 'best_model'), model.state_dict(),
                         model.config)
    for split, n in (('Train', 3), ('Validate', 2), ('Test', 2)):
        dataset_utils.process_and_save(tiny_cache_samples(n, split),
                                       str(root / 'Processed' / split))
    return str(root / 'eval'), str(root / 'Processed') + '/'


@pytest.fixture(scope='module')
def cluster(caches, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('cluster'))
    reports = launch(out, 2, CLUSTER_CASES, eval_cache=caches[0], trainer_cache=caches[1])
    return out, reports


@pytest.fixture(scope='module')
def one_process(tmp_path_factory):
    torch.manual_seed(0)
    directory = str(tmp_path_factory.mktemp('one_process') / 'mid')
    losses, state = run_training(None, save_dir=directory)
    return losses, state, directory


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_params_close(got: dict, want: dict, updates: int) -> None:
    """Every entry within 1e-6 of its reference, but entries of a
    zero-in-exact-arithmetic gradient (ROADMAP Queue 3 "Adam on zero
    gradients"), whose float32 noise Adam turns into ±lr an update, held
    to 2·lr an update; those must be few."""
    assert set(got) == set(want)
    loose = total = 0
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        diff = np.abs(np.asarray(got[name], np.float64) - w)
        assert diff.max() <= 2 * LR * updates + 1e-6, (name, diff.max())
        loose += int((diff > 1e-6).sum())
        total += diff.size
    assert loose <= 0.01 * total, (loose, total)


# ---- (a) the sharded loader against the JAX loader ----

@pytest.mark.parametrize('n, processes, shuffle', [(10, 2, True), (9, 4, False), (13, 1, True)])
def test_loader_shards_reassemble_jax_global_batches(n, processes, shuffle):
    """Each process's rows are its contiguous slice of the JAX loader's
    padded global batch, with its ``num_valid``; 9 samples in batches of 8
    over 4 processes leave three all padding; one process is the plain
    loader, with no ``num_valid``."""
    from weed_instance_segmentation_tpu.datasets.loader import DataLoader as JaxDataLoader

    dataset = [{'i': i} for i in range(n)]

    def collate(items):
        return {'i': [it['i'] for it in items]}

    bs = 8 if processes == 4 else 4
    for k in range(processes):
        kw = dict(shuffle=shuffle, seed=3, collate=collate, prefetch=0, process_index=k,
                  process_count=processes)
        got = list(DataLoader(dataset, bs, **kw))
        want = list(JaxDataLoader(dataset, bs, **kw))
        assert got == want and len(got) == -(-n // bs)
        if processes == 1:
            assert all('num_valid' not in b for b in got)
    if processes == 4:
        last = [list(DataLoader(dataset, 8, collate, process_index=k, process_count=4,
                                prefetch=0))[-1] for k in range(4)]
        assert [b['num_valid'] for b in last] == [1, 0, 0, 0]


def test_mask_padding_marks_rows_invalid():
    """``device_batches`` zeroes ``sample_valid`` and ``instance_valid`` of
    the rows past ``num_valid``, as the JAX trainer's ``_device_batches``."""
    collate = dataset_utils.make_train_collate(HW, N_MAX, 2)
    loader = DataLoader(train_samples(3), 4, collate, prefetch=0, process_index=1,
                        process_count=2)
    (batch,) = list(device_batches(loader, torch.device('cpu')))
    assert 'num_valid' not in batch
    assert batch['sample_valid'].tolist() == [1.0, 0.0]
    assert batch['instance_valid'][1].sum() == 0 and batch['instance_valid'][0].sum() == 3


# ---- (b) the per-rank normalisation against the JAX global-batch loss ----

@functools.cache
def _jax_global_loss():
    """The JAX ``total_loss`` of a whole batch and its gradients with
    respect to every layer's logits, compiled once for the cases below."""
    import jax

    from weed_instance_segmentation_tpu.losses import criterion as jax_criterion
    from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2FormerOutput

    def loss(ms, cs, tm, tc, tv, key):
        out = Mask2FormerOutput(class_queries_logits=cs[-1], masks_queries_logits=ms[-1],
                                aux_class_queries_logits=tuple(cs[:-1]),
                                aux_masks_queries_logits=tuple(ms[:-1]))
        return jax_criterion.total_loss(out, tm, tc, tv, key, num_labels=LABELS,
                                        train_num_points=POINTS)[0]

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


@pytest.mark.parametrize('counts', [(3, 2, 1, 4), (4, 4, 0, 1), (0, 1, 0, 0)],
                         ids=['mixed', 'unequal-halves', 'fewer-targets-than-ranks'])
def test_half_batch_losses_average_to_jax_global_loss(counts):
    """Port ``total_loss`` on each half of a global batch of 4, its
    normalisers fed the global sums (``loss_normalisers`` over an emulated
    all-reduce), averaged over the halves, equals the JAX ``total_loss`` of
    the whole batch with its draws replayed, and so do the gradients (f32,
    rtol 1e-5). The halves' matched counts differ; in the last case the
    batch holds one target for two ranks."""
    import jax
    import jax.numpy as jnp

    from weed_instance_segmentation_tpu_torch.losses.criterion import PointDraws, total_loss
    from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2FormerOutput

    rng = np.random.default_rng(sum(counts) + 17)
    b, q, layers, points, hw = 4, 10, 3, POINTS, (16, 24)
    tm = np.zeros((b, N_MAX, 32, 48), np.float32)
    tc = np.zeros((b, N_MAX), np.int32)
    tv = np.zeros((b, N_MAX), bool)
    for i, c in enumerate(counts):
        for j in range(c):
            y, x = rng.integers(0, 20), rng.integers(0, 30)
            tm[i, j, y:y + rng.integers(4, 12), x:x + rng.integers(4, 16)] = 1.0
            tc[i, j], tv[i, j] = rng.integers(0, LABELS), True
    masks = [rng.standard_normal((b, q, *hw)).astype(np.float32) * 3 for _ in range(layers)]
    classes = [rng.standard_normal((b, q, LABELS + 1)).astype(np.float32) for _ in range(layers)]
    key = jax.random.PRNGKey(21)
    kwargs = dict(num_labels=LABELS, train_num_points=points)

    want, want_grads = _jax_global_loss()(
        [jnp.asarray(m) for m in masks], [jnp.asarray(c) for c in classes], jnp.asarray(tm),
        jnp.asarray(tc), jnp.asarray(tv), key)
    arrays = {}
    for layer, k in enumerate(jax.random.split(key, layers)):
        r_match, r_points = jax.random.split(k)
        r1, r2 = jax.random.split(r_points)
        arrays['matcher', layer] = np.asarray(jax.random.uniform(r_match, (b, points, 2)))
        arrays['oversample', layer] = np.asarray(
            jax.random.uniform(r1, (b * N_MAX, 3 * points, 2)))
        arrays['redraw', layer] = np.asarray(
            jax.random.uniform(r2, (b * N_MAX, points - int(0.75 * points), 2)))

    class HalfDraws(PointDraws):
        """Rows ``half`` of the JAX draws, as a data rank keeps them."""

        def __init__(self, half):
            super().__init__()
            self.half = half

        def uniform(self, kind, layer, shape, device):
            rows = arrays[kind, layer][self.half * shape[0]:(self.half + 1) * shape[0]]
            assert rows.shape == tuple(shape)
            return torch.from_numpy(rows)

    tensors = [torch.from_numpy(a).requires_grad_() for a in masks + classes]

    def half_loss(half, normalisers):
        rows = slice(2 * half, 2 * half + 2)
        out = Mask2FormerOutput(
            class_queries_logits=tensors[-1][rows], masks_queries_logits=tensors[layers - 1][rows],
            aux_class_queries_logits=tuple(t[rows] for t in tensors[layers:-1]),
            aux_masks_queries_logits=tuple(t[rows] for t in tensors[:layers - 1]))
        return total_loss(out, torch.from_numpy(tm[rows]), torch.from_numpy(tc[rows]),
                          torch.from_numpy(tv[rows]), HalfDraws(half), **kwargs,
                          **normalisers)[0]

    # pass 1 records each hook call's local sum; pass 2 feeds their sums
    local = [[], []]
    for half in (0, 1):
        def record(t, h=half):
            local[h].append(t.clone())
            return t.clamp(min=1e-8)

        half_loss(half, {'num_masks_reduce': record, 'class_weight_reduce': record})
    sums = [a + b for a, b in zip(*local)]
    assert len(sums) == 2 * layers
    total = 0.0
    for half in (0, 1):
        it = iter(sums)
        total = total + half_loss(half, pmesh.loss_normalisers(lambda t: next(it), 2)) / 2
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    total.backward()
    for t, w in zip(tensors, list(want_grads[0]) + list(want_grads[1])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


# ---- (c)-(f): the two-rank cluster against one process ----

def test_every_parameter_gets_a_gradient():
    """Why DDP's ``find_unused_parameters`` stays False
    (``parallel/mesh.py::wrap_model``): one micro-step with drop path on
    reaches every parameter."""
    model = train_model()
    step = make_train_step(model, model.config, make_optimizer(model.parameters(), LR), 2)
    collate = dataset_utils.make_train_collate(HW, N_MAX, 2)
    (batch,) = list(device_batches(DataLoader(train_samples(2), 2, collate, prefetch=0), 'cpu'))
    step(batch)
    assert [n for n, p in model.named_parameters() if p.grad is None] == []


def test_ddp_two_ranks_match_one_process(cluster, one_process):
    """Two DDP ranks at tiny-test, 6 micro-steps with accumulation 2 (three
    updates; rank 1's last batch all padding): the averaged losses are one
    process's on the global batches (rtol 1e-5), equal on both ranks, and
    the parameters agree (``assert_params_close``)."""
    out, reports = cluster
    want_losses, want_state, _ = one_process
    np.testing.assert_allclose(reports[0]['ddp'], want_losses, rtol=1e-5)
    assert reports[0]['ddp'] == reports[1]['ddp']
    assert_params_close(_npz(os.path.join(out, 'ddp.npz')),
                        {k: v.numpy() for k, v in want_state.items()}, STEPS // ACCUMULATION)


def test_fsdp_model_axis_matches_ddp(cluster, one_process):
    """dp1×mp2 (FSDP2 over 'model', both ranks on every row) gives the
    losses of the DDP run and of one process (rtol 1e-5) and its
    parameters, gathered whole."""
    out, reports = cluster
    np.testing.assert_allclose(reports[0]['fsdp'], reports[0]['ddp'], rtol=1e-5)
    np.testing.assert_allclose(reports[1]['fsdp'], one_process[0], rtol=1e-5)
    assert_params_close(_npz(os.path.join(out, 'fsdp.npz')), _npz(os.path.join(out, 'ddp.npz')),
                        STEPS // ACCUMULATION)


@pytest.mark.parametrize('kind', ['ddp', 'fsdp'])
def test_mid_cycle_resume_matches_uninterrupted(cluster, one_process, kind):
    """A train state written mid-cycle (micro-step 3 of accumulation 2) by
    two ranks holds what one process writes there (the unfinished cycle's
    gradient averaged over the ranks, sharded tensors gathered whole); two
    fresh ranks resumed from it end where the uninterrupted run does."""
    out, reports = cluster
    got = _npz(os.path.join(out, f'{kind}_mid', ckpt.OPT_STATE_FILE))
    want = _npz(os.path.join(one_process[2], ckpt.OPT_STATE_FILE))
    assert set(got) == set(want) and int(got['mini_step']) == 1
    for key in want:  # float32 sums over other splits of the batch: 1e-4 of each leaf
        err, scale = np.abs(got[key] - want[key]).max(), np.abs(want[key]).max()
        assert err <= max(1e-4 * scale, 1e-6), (key, err, scale)
    with open(os.path.join(out, f'{kind}_mid', ckpt.TRAIN_META_FILE)) as f:
        assert json.load(f)['step'] == MID
    np.testing.assert_allclose(reports[0][f'{kind}_resume'], reports[0][kind][MID:], rtol=1e-5)
    assert_params_close(_npz(os.path.join(out, f'{kind}_resume.npz')),
                        _npz(os.path.join(out, f'{kind}.npz')), 2)


def test_two_rank_metrics_equal_one_process(cluster, caches):
    """The sharded test phase (rank 1's second batch all padding) gives the
    one-process metric dict on rank 0; rank 1 returns {}."""
    _, reports = cluster
    want = run_metrics(caches[0])
    assert reports[1]['metrics'] == {}
    got = reports[0]['metrics']
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    assert 0.0 < want['map'] < 1.0


def test_engine_test_as_two_processes(cluster, caches, monkeypatch):
    """``python -m ...engine.test`` run as two processes scores the split
    as one process does; rank 1 returns {}."""
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed

    for module, name in ((config, 'MODELS_OUTPUT_DIR'), (config, 'DATASET_LIST'),
                         (config, 'BATCH_SIZE'), (config, 'DATA_PARALLEL'),
                         (crop_weed, 'PROCESSED_DIR')):
        monkeypatch.setattr(module, name, getattr(module, name))
    want = run_engine_test(os.path.dirname(caches[0]))
    _, reports = cluster
    assert reports[1]['engine_test'] == {} and set(reports[0]['engine_test']) == set(want)
    for key in want:
        np.testing.assert_allclose(reports[0]['engine_test'][key], want[key], atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize('case', ['trainer_dp2', 'trainer_mp2'])
def test_trainer_as_two_processes(cluster, case):
    """``engine.train.main()`` as two ranks (``DATA_PARALLEL=2``, and
    ``DATA_PARALLEL=1 MODEL_PARALLEL=2``): one run directory with the
    metadata, a finite history and test metrics, ``best_model/``,
    ``final_model/`` and ``train_state/``, every file written by rank 0
    alone."""
    out, reports = cluster
    (run_dir,) = [os.path.join(r, d) for r, ds, _ in os.walk(os.path.join(out, case))
                  for d in ds if r.endswith('mask2former_fine_tuned')]
    with open(os.path.join(run_dir, 'metadata.json')) as f:
        metadata = json.load(f)
    (entry,) = metadata['training_history']
    assert np.isfinite(entry['train_loss']) and np.isfinite(entry['val_loss'])
    assert 'map' in metadata['test_metrics'] and metadata['batch_size'] == 2
    for sub in ('best_model', 'final_model', 'train_state'):
        assert os.path.isdir(os.path.join(run_dir, sub)), sub
    assert reports[1][case] == []
    assert os.path.join(run_dir, 'metadata.json') in reports[0][case]
    assert os.path.join(run_dir, 'train_state', ckpt.OPT_STATE_FILE) in reports[0][case]


@pytest.mark.slow
def test_fsdp_two_by_two_matches_one_process(tmp_path, one_process):
    """dp2×mp2 over four ranks gives one process's losses (rtol 1e-5)."""
    reports = launch(str(tmp_path), 4, ('fsdp_2x2',))
    for report in reports:
        np.testing.assert_allclose(report['fsdp_2x2'], one_process[0], rtol=1e-5)


if __name__ == '__main__':
    _worker(json.loads(sys.argv[1]))
