"""Train, eval and inference steps.

Port of ``weed_instance_segmentation_tpu/engine/steps.py``:

- ``make_optimizer``: ``torch.optim.AdamW`` with torch's defaults (betas
  (0.9, 0.999), eps 1e-8, weight decay 0.01 on every parameter), the same
  decoupled update as the JAX package's ``optax.adamw``.
- Gradient accumulation with ``optax.MultiSteps`` semantics: the update uses
  the mean of ``gradient_accumulation`` micro-step gradients and happens on
  every k-th call; parameters are untouched in between, Adam's step count
  counts updates only, and a cycle runs on across epochs.
- Each micro-step's random draws (augmentation, drop path and point
  sampling) come from a generator seeded from (seed, micro-step),
  :func:`step_draws`.
- Data parallelism (``parallel/mesh.py``): the model arrives wrapped by
  ``wrap_model``, every rank runs the step on its own rows, and the loss
  is normalised by the global counts (``loss_reducers``), so the gradient
  the ranks average is the global batch's, as in the JAX program. Each
  rank draws the global batch's random numbers and keeps its own rows, so
  W ranks reproduce one process's step. Under DDP the gradients are
  all-reduced only on the last micro-step of a cycle (``no_sync`` before
  it). Under FSDP2 they are reduce-scattered on every micro-step: the
  sharded ``.grad`` then holds the cycle's sum, the average over ranks,
  where a mid-cycle save can gather it (``full_tensor``); with
  ``set_requires_gradient_sync(False)`` the rank-local unsharded sums sit
  in FSDP2's private state, out of a save's reach. The reported loss is
  the mean over ranks.
- ``augment`` (``processing/augment.py``) runs on the batch inside the loss
  function, before the forward, where the JAX ``make_loss_fn`` puts it.
- The forward runs under ``torch.autocast`` in ``compute_dtype`` when that is
  not float32 (float32 parameters, the master copy); the criterion runs in
  float32; the MSDA core keeps float32 coordinates (models/pixel_decoder.py).
- A train step's four parts run in ``torch.profiler.record_function`` ranges
  named ``forward``, ``criterion``, ``backward`` and ``optimizer``, so a
  profiler trace of real steps splits their time.

``make_forward_fn`` is the inference forward of the evaluation path.

A batch is the dict of ``datasets/dataset_utils.py::pad_batch_static`` as
tensors on the model's device (``datasets/loader.py::to_device``).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from weed_instance_segmentation_tpu_torch.losses.criterion import PointDraws, total_loss
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.parallel.mesh import (
    data_coordinate, loss_reducers, no_grad_sync, rank_mean,
)
from weed_instance_segmentation_tpu_torch.processing.augment import AugmentConfig, augment_batch


def make_optimizer(params, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def make_loss_fn(model: torch.nn.Module, cfg: Mask2FormerConfig,
                 compute_dtype: torch.dtype = torch.float32,
                 augment: AugmentConfig | None = None, mesh=None) -> Callable:
    """(batch, draws) → (total loss, weighted loss dict): with ``augment``
    the batch augmented first; on ``mesh``, this rank's share of the global
    batch's loss."""
    reducers = loss_reducers(mesh)

    def loss_fn(batch: dict, draws: PointDraws):
        with record_function('forward'):
            if augment is not None:
                batch = augment_batch(batch, augment, draws.generator, draws.shard)
            pixels = batch['pixel_values']
            with _autocast(pixels.device, compute_dtype):
                outputs = model(pixels, draws.generator, draws.shard)
        with record_function('criterion'):
            return total_loss(
                outputs, batch['mask_labels'].float(), batch['class_labels'],
                batch['instance_valid'] > 0, draws,
                num_labels=cfg.num_labels, no_object_weight=cfg.no_object_weight,
                train_num_points=cfg.train_num_points, oversample_ratio=cfg.oversample_ratio,
                importance_sample_ratio=cfg.importance_sample_ratio,
                class_weight=cfg.class_weight, mask_weight=cfg.mask_weight,
                dice_weight=cfg.dice_weight, use_auxiliary_loss=cfg.use_auxiliary_loss,
                sample_valid=batch.get('sample_valid'), **reducers)

    return loss_fn


def step_draws(seed: int, index: int, device: str | torch.device,
               shard: tuple[int, int] | None = None) -> PointDraws:
    """The draws of call ``index`` of a step seeded ``seed``: a generator on
    ``device`` seeded from the pair, as the JAX package folds the step into
    its key (``jax.random.fold_in``), so the draws of a call depend on its
    index alone and a resumed run repeats an uninterrupted one's. ``shard``
    (a data rank's (index, count)) keeps the rank's rows of each draw."""
    key = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return PointDraws(torch.Generator(device=device).manual_seed(key), shard)


class TrainStep:
    """(batch, draws=None) → loss of this micro-batch (a detached scalar; on
    a mesh, the mean over ranks: the global batch's loss).

    One micro-batch per call; the optimizer steps on every
    ``gradient_accumulation``-th call with the mean gradient, which stays in
    each parameter's ``.grad`` until the next cycle's first backward. The
    call's random numbers come from its ``draws``, or else from
    ``step_draws(seed, micro_steps)`` (this rank's rows of them on a
    mesh). ``micro_steps`` (the calls taken, JAX ``TrainState.step``) and
    ``mini_step`` (the position in the accumulation cycle,
    ``optax.MultiSteps``' ``mini_step``) are what the train checkpoint saves
    and restores, with the parameters' ``.grad``. ``model`` is the module,
    or on ``mesh`` its ``parallel/mesh.py::wrap_model`` wrapper."""

    def __init__(self, model: torch.nn.Module, cfg: Mask2FormerConfig,
                 optimizer: torch.optim.Optimizer, gradient_accumulation: int = 1,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                 augment: AugmentConfig | None = None, mesh=None):
        if gradient_accumulation < 1:
            raise ValueError(f'gradient_accumulation must be >= 1, got {gradient_accumulation}')
        self.model = model
        self.loss_fn = make_loss_fn(model, cfg, compute_dtype, augment, mesh)
        self.optimizer = optimizer
        self.gradient_accumulation = gradient_accumulation
        self.seed = seed
        self.shard = None if mesh is None else data_coordinate(mesh)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.micro_steps = 0
        self.mini_step = 0

    def __call__(self, batch: dict, draws: PointDraws | None = None) -> torch.Tensor:
        if self.mini_step == 0:
            self.optimizer.zero_grad(set_to_none=True)
        if draws is None:
            draws = step_draws(self.seed, self.micro_steps, self.params[0].device, self.shard)
        with no_grad_sync(self.model, sync=self.mini_step + 1 == self.gradient_accumulation):
            loss, _ = self.loss_fn(batch, draws)
            with record_function('backward'):
                loss.backward()
        self.micro_steps += 1
        self.mini_step = (self.mini_step + 1) % self.gradient_accumulation
        if self.mini_step == 0:
            with record_function('optimizer'):
                if self.gradient_accumulation > 1:
                    for p in self.params:
                        if p.grad is not None:
                            p.grad.div_(self.gradient_accumulation)
                self.optimizer.step()
        return rank_mean(loss.detach())


def make_train_step(model: torch.nn.Module, cfg: Mask2FormerConfig,
                    optimizer: torch.optim.Optimizer, gradient_accumulation: int = 1,
                    compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                    augment: AugmentConfig | None = None, mesh=None) -> TrainStep:
    """The :class:`TrainStep` of ``model``."""
    return TrainStep(model, cfg, optimizer, gradient_accumulation, compute_dtype, seed,
                     augment, mesh)


def make_eval_step(model: torch.nn.Module, cfg: Mask2FormerConfig,
                   compute_dtype: torch.dtype = torch.float32, mesh=None) -> Callable:
    """(batch, draws) → forward-only loss, with the model in eval mode (no
    drop path); fixed ``draws`` give a stable validation metric. On
    ``mesh``, each rank takes its rows and the result is the mean over
    ranks, the global batch's loss."""
    loss_fn = make_loss_fn(model, cfg, compute_dtype, mesh=mesh)

    @torch.no_grad()
    def eval_step(batch: dict, draws: PointDraws) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            return rank_mean(loss_fn(batch, draws)[0])
        finally:
            model.train(was_training)

    return eval_step


def make_forward_fn(model: torch.nn.Module) -> Callable:
    """(pixel_values) → ``Mask2FormerOutput``: the model's forward in eval
    mode (no drop path) under ``torch.no_grad()``, in the dtype the model
    holds (the JAX package's ``make_forward_fn`` takes the params as an
    argument; here the model holds them)."""

    @torch.no_grad()
    def forward(pixel_values: torch.Tensor):
        model.eval()
        return model(pixel_values)

    return forward
