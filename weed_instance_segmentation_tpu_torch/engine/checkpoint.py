"""Model and train-state checkpoints.

Port of ``weed_instance_segmentation_tpu/engine/checkpoint.py``.

A model directory (:func:`save_pretrained`) holds ``config.json`` (the HF
layout, ``Mask2FormerConfig.save_json``), ``params.npz``, the flax parameter
tree flattened with its keys joined by ``/``
(``backbone/stage0_block0/attention/query/kernel``), float32, and, where a
processor is given, its ``preprocessor_config.json``. The names and layouts
come from ``models/convert.py::flax_leaf`` and go back through
``params_from_jax``, so a directory either package writes loads in the
other. A directory without ``params.npz`` is read as an HF checkpoint
(``models/convert.py::load_hf_checkpoint``), as the JAX package does.

A train-state directory (:func:`save_train_checkpoint`, the resume point)
holds ``params.npz`` as above, ``opt_state.npz`` and ``train_state.json``.
``opt_state.npz`` holds, by each parameter's flax name and in its flax
layout, what ``optax.MultiSteps(adamw)`` holds: the AdamW moments
(``exp_avg/<name>``, ``exp_avg_sq/<name>``) and step count (``step/<name>``),
the gradient of an unfinished accumulation cycle (``acc_grad/<name>``; the
sum of the cycle's micro-step gradients, zero between cycles) and the
cycle's position (``mini_step``). ``train_state.json`` holds ``step``, the
micro-steps taken (JAX ``TrainState.step``), and the caller's extras. The
keys are the port's own: a train state written by one package does not
resume in the other.

Arrays are written one at a time into the ``.npz`` (a zip of ``.npy``
files, as ``np.savez`` writes it), so a save holds at most one parameter's
host copy at once, not a second copy of the model.

Under data parallelism (``parallel/mesh.py``) every rank calls a save at
the same point and rank 0 alone writes: the tensors of an FSDP2-sharded
model (parameters, AdamW moments, the accumulated gradient) are gathered
whole, one at a time, by a collective every rank joins; the unfinished
cycle's gradient of a DDP run, rank-local under ``no_sync``, is averaged
over the ranks first. So the files are those one process would write. A
load restores into a DDP-wrapped or FSDP2-sharded model and its
optimizer on every rank, each tensor in its parameter's layout.
"""

from __future__ import annotations

import json
import os
import zipfile
from collections.abc import Iterable, Mapping

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import (
    flax_leaf, flax_path, load_hf_checkpoint, params_from_jax, torch_leaf,
)
from weed_instance_segmentation_tpu_torch.parallel.mesh import (
    fetch_state, is_main, is_sharded, like_parameter, process_count, rank_mean, unwrap,
)
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)

PARAMS_FILE = 'params.npz'
OPT_STATE_FILE = 'opt_state.npz'
TRAIN_META_FILE = 'train_state.json'
MOMENTS = ('exp_avg', 'exp_avg_sq')


def _write_npz(path: str, items: Iterable[tuple[str, np.ndarray]]) -> None:
    """``np.savez(path, **dict(items))``, drawing and writing one array at
    a time; on a rank other than 0 the items are drawn (their gathers are
    collectives) and nothing is written."""
    if not is_main():
        for _ in items:
            pass
        return
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, array in items:
            with zf.open(key + '.npy', 'w', force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(array), allow_pickle=False)


def _flax_items(named: Iterable[tuple[str, torch.Tensor]], prefix: str = ''):
    """(``prefix`` + flax key, flax-layout array) of each (name, tensor),
    a sharded tensor gathered whole first. On a rank other than 0 the
    gathers run and nothing is yielded: rank 0 alone converts and writes."""
    for name, tensor in fetch_state(named):
        if not is_main():
            continue
        path, array = flax_leaf(name, tensor)
        yield prefix + '/'.join(path), array


def save_pretrained(directory: str, state_dict: Mapping[str, torch.Tensor],
                    cfg: Mask2FormerConfig,
                    processor: Mask2FormerImageProcessor | None = None) -> None:
    """``config.json`` + ``params.npz`` of ``state_dict`` (a model's, on any
    device and in any dtype, sharded or not; written as float32), and the
    processor's ``preprocessor_config.json`` where one is given. Every rank
    calls it; rank 0 writes."""
    if is_main():
        os.makedirs(directory, exist_ok=True)
        cfg.save_json(directory)
    _write_npz(os.path.join(directory, PARAMS_FILE), _flax_items(state_dict.items()))
    if processor is not None and is_main():
        processor.save_pretrained(directory)


def _read_params(path: str) -> dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as z:
        return params_from_jax(_unflatten({k: z[k] for k in z.files}))


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, name = key.split('/')
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value
    return tree


def load_pretrained(directory: str) -> tuple[Mask2FormerConfig, dict[str, torch.Tensor]]:
    """(config, CPU ``state_dict``) from a directory written by either
    package's ``save_pretrained``, or from an HF checkpoint directory."""
    params_path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(params_path):
        return load_hf_checkpoint(directory)
    return Mask2FormerConfig.from_json(directory), _read_params(params_path)


def load_processor(directory: str) -> Mask2FormerImageProcessor:
    return Mask2FormerImageProcessor.from_pretrained(directory)


def _opt_keys(model: torch.nn.Module) -> list[str]:
    keys = []
    for name, p in model.named_parameters():
        flax = '/'.join(flax_path(name, p.dim()))
        keys += [f'{kind}/{flax}' for kind in (*MOMENTS, 'step', 'acc_grad')]
    return keys + ['mini_step']


def save_train_checkpoint(directory: str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, train_step,
                          extra: dict | None = None) -> None:
    """The resume point of a run: ``model``'s parameters, ``optimizer``'s
    AdamW state, and ``train_step``'s (``engine/steps.py::TrainStep``)
    counters and unfinished accumulated gradient, plus ``extra``. ``model``
    may be wrapped or sharded (``parallel/mesh.py::wrap_model``); every
    rank calls it, rank 0 writes."""
    model = unwrap(model)
    if is_main():
        os.makedirs(directory, exist_ok=True)
    _write_npz(os.path.join(directory, PARAMS_FILE), _flax_items(model.state_dict().items()))

    def opt_items():
        for name, p in model.named_parameters():
            state = optimizer.state.get(p, {})  # empty before the first update
            acc = p.grad if train_step.mini_step > 0 and p.grad is not None else None
            if acc is not None and process_count() > 1 and not is_sharded(acc):
                acc = rank_mean(acc)  # a DDP rank's own sum under no_sync
            for kind, tensor in (*((k, state.get(k)) for k in MOMENTS), ('acc_grad', acc)):
                yield from _flax_items(
                    [(name, torch.zeros_like(p) if tensor is None else tensor)], kind + '/')
            step = float(state.get('step', 0))
            yield 'step/' + '/'.join(flax_path(name, p.dim())), np.float32(step)
        yield 'mini_step', np.int64(train_step.mini_step)

    _write_npz(os.path.join(directory, OPT_STATE_FILE), opt_items())
    if is_main():
        with open(os.path.join(directory, TRAIN_META_FILE), 'w') as f:
            json.dump({'step': train_step.micro_steps, **(extra or {})}, f, indent=2)


def load_train_checkpoint(directory: str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, train_step) -> dict:
    """Restore what :func:`save_train_checkpoint` wrote into ``model``,
    ``optimizer`` (built over ``model.parameters()``) and ``train_step``;
    returns the ``train_state.json`` dict. A key set that differs from the
    one this model and optimizer would write raises instead of restoring
    leaves by position. ``model`` may be wrapped or sharded; every rank
    calls it and restores the same state, each tensor in its parameter's
    layout."""
    model = unwrap(model)
    current = model.state_dict()
    loaded = _read_params(os.path.join(directory, PARAMS_FILE))
    model.load_state_dict({
        k: like_parameter(current[k], v.to(current[k].device)) if is_sharded(current.get(k))
        else v for k, v in loaded.items()}, strict=True)
    with np.load(os.path.join(directory, OPT_STATE_FILE), allow_pickle=False) as z:
        want = _opt_keys(model)
        missing = sorted(set(want) - set(z.files))
        surplus = sorted(set(z.files) - set(want))
        if missing or surplus:
            raise ValueError(
                f'optimizer-state layout mismatch restoring {directory!r}: '
                f'{len(missing)} expected keys missing (e.g. {missing[:3]}), '
                f'{len(surplus)} saved keys unused (e.g. {surplus[:3]})')
        mini_step = int(z['mini_step'])

        def read(kind, flax, p):
            _, array = torch_leaf(flax, z[f'{kind}/{flax}'])
            return like_parameter(
                p, torch.from_numpy(np.ascontiguousarray(array)).to(p.device, p.dtype))

        for name, p in model.named_parameters():
            flax = '/'.join(flax_path(name, p.dim()))
            optimizer.state[p] = {
                'step': torch.tensor(float(z[f'step/{flax}']), dtype=torch.float32),
                **{kind: read(kind, flax, p) for kind in MOMENTS}}
            p.grad = read('acc_grad', flax, p) if mini_step > 0 else None
    with open(os.path.join(directory, TRAIN_META_FILE)) as f:
        meta = json.load(f)
    train_step.micro_steps = int(meta['step'])
    train_step.mini_step = mini_step
    return meta
