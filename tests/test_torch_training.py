"""The port's training slice against the JAX package on the CPU, float32:
matcher, assignment, uncertainty points, the loss, one whole train step with
gradient accumulation 2, remat, the ``.npz`` cache and the parameter
conversion.

Random draws are the JAX package's: :class:`JaxDraws` replays its key
schedule (``total_loss`` splits the loss key per layer; each layer key splits
into the matcher's and the point losses' keys, ``losses/criterion.py:546,
558, 412, 350-367``) through the port's ``PointDraws`` interface. Weights
cross over with ``params_from_jax`` from seeded-noise flax params.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.datasets import dataset_utils as jax_dataset_utils
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.engine.steps import (
    create_train_state, make_eval_step as jax_make_eval_step, make_loss_fn as jax_make_loss_fn,
    make_train_step as jax_make_train_step,
)
from weed_instance_segmentation_tpu.losses import criterion as jax_criterion
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.ops.lap import linear_sum_assignment as jax_lsa

from weed_instance_segmentation_tpu_torch.datasets import dataset_utils
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader, to_device
from weed_instance_segmentation_tpu_torch.engine.steps import (
    make_eval_step, make_optimizer, make_train_step,
)
from weed_instance_segmentation_tpu_torch.losses.criterion import (
    PointDraws, _uncertainty_points, hungarian_match, mask2former_loss, matcher_cost,
    pad_targets, total_loss,
)
from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, SwinConfig,
)
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax, state_dict_to_jax
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former, Mask2FormerOutput
from weed_instance_segmentation_tpu_torch.ops.lap import linear_sum_assignment

IMAGE_HW = (64, 96)
NUM_LABELS = 3
LEARNING_RATE = 5e-5


class JaxDraws(PointDraws):
    """The JAX criterion's draws from ``loss_key``, replayed by (kind, layer)."""

    def __init__(self, loss_key, num_layers: int, batch: int, pairs: int, points: int):
        super().__init__()
        self.arrays = {}
        for layer, key in enumerate(jax.random.split(loss_key, num_layers)):
            r_match, r_points = jax.random.split(key)
            r1, r2 = jax.random.split(r_points)
            self.arrays['matcher', layer] = jax.random.uniform(r_match, (batch, points, 2))
            self.arrays['oversample', layer] = jax.random.uniform(r1, (pairs, 3 * points, 2))
            self.arrays['redraw', layer] = jax.random.uniform(
                r2, (pairs, points - int(0.75 * points), 2))

    def uniform(self, kind, layer, shape, device):
        array = np.asarray(self.arrays[kind, layer])
        assert array.shape == tuple(shape), (kind, layer, array.shape, shape)
        return torch.from_numpy(array).to(device)


def _np(t):
    return t.detach().numpy()


def _targets(seed, batch=2, n_max=4, hw=IMAGE_HW):
    """Rectangle masks, 3 and 2 real instances, padded to ``n_max``."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((batch, n_max, *hw), np.float32)
    classes = np.zeros((batch, n_max), np.int32)
    valid = np.zeros((batch, n_max), bool)
    for b, count in enumerate((3, 2)[:batch]):
        for i in range(count):
            y, x = rng.integers(0, hw[0] - 16), rng.integers(0, hw[1] - 16)
            masks[b, i, y:y + rng.integers(6, 16), x:x + rng.integers(6, 16)] = 1.0
            classes[b, i] = rng.integers(0, NUM_LABELS)
            valid[b, i] = True
    return masks, classes, valid


def _outputs(seed, layers=3, batch=2, q=10, hw=(16, 24)):
    rng = np.random.default_rng(seed)
    masks = [rng.standard_normal((batch, q, *hw)).astype(np.float32) * 3 for _ in range(layers)]
    classes = [rng.standard_normal((batch, q, NUM_LABELS + 1)).astype(np.float32)
               for _ in range(layers)]
    return masks, classes


def _port_outputs(masks, classes, requires_grad=False):
    ts = [torch.from_numpy(a).requires_grad_(requires_grad) for a in masks + classes]
    n = len(masks)
    out = Mask2FormerOutput(class_queries_logits=ts[-1], masks_queries_logits=ts[n - 1],
                           aux_class_queries_logits=tuple(ts[n:-1]),
                           aux_masks_queries_logits=tuple(ts[:n - 1]))
    return out, ts


def test_matcher_cost_on_fixed_points():
    masks, classes = _outputs(0, layers=1)
    tm, tc, tv = _targets(1)
    coords = np.random.default_rng(2).random((2, 128, 2)).astype(np.float32)
    want = jax_criterion.matcher_cost(
        jnp.asarray(masks[0]), jnp.asarray(classes[0]), jnp.asarray(tm), jnp.asarray(tc),
        jnp.asarray(tv), None, 128, 2.0, 5.0, 5.0, point_coords=jnp.asarray(coords))
    got = matcher_cost(torch.from_numpy(masks[0]), torch.from_numpy(classes[0]),
                       torch.from_numpy(tm), torch.from_numpy(tc), torch.from_numpy(tv),
                       torch.from_numpy(coords), 2.0, 5.0, 5.0)
    assert got.shape == (2, 4, 10)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    assert not _np(got)[1, 2:].any()  # padded slots: a constant (zero) row


def test_pad_targets_matches_jax():
    rng = np.random.default_rng(9)
    masks = [rng.random((n, 6 + n, 9)) > 0.5 for n in (3, 0, 5)]
    classes = [rng.integers(0, 4, len(m)) for m in masks]
    for kwargs in ({}, {'mask_hw': (12, 10)}):
        got = pad_targets(masks, classes, 4, **kwargs)
        want = jax_criterion.pad_targets(masks, classes, 4, **kwargs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('shape', [(5, 5), (4, 10), (1, 7), (12, 30)])
def test_lap_matches_jax_jv(shape):
    for seed in range(4):
        cost = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 10
        want = np.asarray(jax_lsa(jnp.asarray(cost)))
        np.testing.assert_array_equal(linear_sum_assignment(cost), want)
    with pytest.raises(ValueError, match='R <= C'):
        linear_sum_assignment(np.zeros((3, 2)))


@pytest.mark.parametrize('tie', [False, True], ids=['random', 'ties'])
def test_uncertainty_points_match_jax(tie):
    """Same kept points as the JAX package's stable sort; with ties (a
    constant mask: every |logit| equal) the lower candidate index wins."""
    rng = np.random.default_rng(3)
    pred = np.zeros((3, 16, 24), np.float32) if tie else \
        rng.standard_normal((3, 16, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax_criterion._uncertainty_points(jnp.asarray(pred), key, 64, 3.0, 0.75)

    class Draws(PointDraws):
        def uniform(self, kind, layer, shape, device):
            r1, r2 = jax.random.split(key)
            return torch.from_numpy(np.asarray(jax.random.uniform(
                r1 if kind == 'oversample' else r2, shape)))

    got = _uncertainty_points(torch.from_numpy(pred), Draws(), 0, 64, 3.0, 0.75)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    if tie:  # the first 48 candidates, in order
        r1, _ = jax.random.split(key)
        np.testing.assert_array_equal(_np(got)[:, :48],
                                      np.asarray(jax.random.uniform(r1, (3, 192, 2)))[:, :48])


def _loss_kwargs(points=64):
    return dict(num_labels=NUM_LABELS, train_num_points=points)


def test_mask2former_loss_matches_jax():
    """One layer matched as ``total_loss`` matches it (``matcher_cost`` on the
    replayed matcher draw, then ``hungarian_match``), a short batch
    (sample_valid), and the gradients of the logits: within 1e-5."""
    masks, classes = _outputs(4, layers=1)
    tm, tc, tv = _targets(5)
    sample_valid = np.array([1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(11)

    def jax_loss(m, c):
        d = jax_criterion.mask2former_loss(m, c, jnp.asarray(tm), jnp.asarray(tc),
                                           jnp.asarray(tv), key,
                                           sample_valid=jnp.asarray(sample_valid),
                                           **_loss_kwargs())
        return sum(d.values()), d

    (want_total, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(masks[0]), jnp.asarray(classes[0]))

    class Draws(JaxDraws):  # mask2former_loss takes the layer key itself
        def __init__(self):
            PointDraws.__init__(self)
            r_match, r_points = jax.random.split(key)
            r1, r2 = jax.random.split(r_points)
            self.arrays = {('matcher', 0): jax.random.uniform(r_match, (2, 64, 2)),
                           ('oversample', 0): jax.random.uniform(r1, (8, 192, 2)),
                           ('redraw', 0): jax.random.uniform(r2, (8, 16, 2))}

    _, ts = _port_outputs(masks, classes, requires_grad=True)
    draws = Draws()
    tv_used = torch.from_numpy(tv & (sample_valid > 0)[:, None])
    assigned = hungarian_match(matcher_cost(
        ts[0].detach(), ts[1].detach(), torch.from_numpy(tm), torch.from_numpy(tc), tv_used,
        draws.uniform('matcher', 0, (2, 64, 2), 'cpu'), 2.0, 5.0, 5.0))
    got = mask2former_loss(ts[0], ts[1], torch.from_numpy(tm), torch.from_numpy(tc),
                           torch.from_numpy(tv), assigned, draws, 0,
                           sample_valid=torch.from_numpy(sample_valid), **_loss_kwargs())
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)


def test_total_loss_matches_jax():
    """Final + 2 aux layers, weighted dict and total, gradients of every
    layer's logits: within 1e-5."""
    masks, classes = _outputs(6, layers=3)
    tm, tc, tv = _targets(7)
    key = jax.random.PRNGKey(13)

    def jax_loss(ms, cs):
        out = Mask2FormerOutput(class_queries_logits=cs[-1], masks_queries_logits=ms[-1],
                                aux_class_queries_logits=tuple(cs[:-1]),
                                aux_masks_queries_logits=tuple(ms[:-1]))
        return jax_criterion.total_loss(out, jnp.asarray(tm), jnp.asarray(tc), jnp.asarray(tv),
                                        key, **_loss_kwargs())

    (want_total, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(m) for m in masks], [jnp.asarray(c) for c in classes])
    out, ts = _port_outputs(masks, classes, requires_grad=True)
    total, got = total_loss(out, torch.from_numpy(tm), torch.from_numpy(tc),
                            torch.from_numpy(tv), JaxDraws(key, 3, 2, 8, 64), **_loss_kwargs())
    assert set(got) == set(want) and len(got) == 9
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), atol=1e-5)
    total.backward()
    for t, w in zip(ts, list(want_grads[0]) + list(want_grads[1])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)


def _noisy(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, scale, np.shape(x)).astype(np.float32),
        params)


def _batch(seed):
    rng = np.random.default_rng(seed)
    tm, tc, _ = _targets(seed)
    samples = [{'pixel_values': rng.standard_normal((3, *IMAGE_HW)).astype(np.float32),
                'mask_labels': tm[b, :n].astype(np.uint8), 'class_labels': tc[b, :n]}
               for b, n in enumerate((3, 2))]
    return dataset_utils.make_train_collate(IMAGE_HW, 4, 2)(samples)


def _leaf_errors(got_tree, want_tree):
    """Per leaf: max |got − want| / max |want|."""
    errs = {}
    flat_want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    for path, want in flat_want:
        want = np.asarray(want)
        errs[jax.tree_util.keystr(path)] = (np.abs(flat_got[path] - want).max(),
                                            np.abs(want).max())
    return errs


def test_train_step_matches_jax():
    """Two micro-steps of gradient accumulation 2 at tiny-test: each loss
    within 1e-5 relative; the mean gradient the update uses within 1e-4 of
    each leaf's largest entry, for every leaf whose reference gradient
    reaches 1e-6 (a leaf whose largest entry is below that is zero in exact
    arithmetic, float32 noise, and is held to 1e-6 absolute); the parameters
    after the update within 1e-6 (lr 5e-5), except entries whose gradient is
    float32 noise (below)."""
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(num_labels=NUM_LABELS)
    jax_model = JaxMask2Former(jax_cfg)
    params = _noisy(init_params(jax_model, jax_cfg, seed=0, image_hw=IMAGE_HW), seed=1)
    state, tx = create_train_state(params, LEARNING_RATE, gradient_accumulation=2)
    jax_step = jax_make_train_step(jax_model, jax_cfg, tx)
    jax_loss_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jax_model, jax_cfg), has_aux=True))
    key = jax.random.PRNGKey(0)
    batches = [_batch(20), _batch(21)]

    cfg = Mask2FormerConfig.tiny_test(num_labels=NUM_LABELS)
    model = Mask2Former(cfg).train()
    model.load_state_dict(params_from_jax(params), strict=True)
    step = make_train_step(model, cfg, make_optimizer(model.parameters(), LEARNING_RATE), 2)
    points, pairs, layers = cfg.train_num_points, 2 * 4, cfg.decoder_layers

    want_grads = []
    for micro, batch in enumerate(batches):
        rng = jax.random.fold_in(key, micro)  # the JAX step folds in its step count
        (want_loss, _), grads = jax_loss_fn(state.params, batch, rng)
        want_grads.append(grads)
        state, loss = jax_step(state, batch, key)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        draws = JaxDraws(jax.random.fold_in(rng, 2), layers, 2, pairs, points)
        got_loss = step(to_device(batch, 'cpu'), draws)
        np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
        if micro == 0:  # accumulation only: parameters untouched on both sides
            for name, p in model.named_parameters():
                assert torch.equal(p.detach(), params_from_jax(params)[name]), name

    mean_grad = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *want_grads)
    grads = state_dict_to_jax({n: p.grad for n, p in model.named_parameters()})
    grad_errs = _leaf_errors(grads, mean_grad)
    noise_leaves = [leaf for leaf, (_, scale) in grad_errs.items() if scale < 1e-6]
    print(f'gradient leaves below the 1e-6 noise level, held to 1e-6 absolute: {noise_leaves}')
    for leaf, (err, scale) in grad_errs.items():
        assert err <= (1e-6 if leaf in noise_leaves else 1e-4 * scale), (leaf, err, scale)

    # An entry whose gradient is below 1e-6 on both sides (float32 noise: key
    # biases under softmax and biases before a GroupNorm are zero in exact
    # arithmetic) gets an Adam first update of up to ±lr with the noise's
    # sign, so it is held to 2·lr; every other entry to 1e-6.
    after = jax.tree_util.tree_leaves(state_dict_to_jax(model.state_dict()))
    noisy = 0
    for got, want, g_port, g_jax in zip(after, jax.tree_util.tree_leaves(state.params),
                                        jax.tree_util.tree_leaves(grads),
                                        jax.tree_util.tree_leaves(mean_grad)):
        noise = np.maximum(np.abs(g_port), np.abs(np.asarray(g_jax))) < 1e-6
        bound = np.where(noise, 2 * LEARNING_RATE * (1 + 1e-3), 1e-6)
        assert (np.abs(got - np.asarray(want)) <= bound).all()
        noisy += int(noise.sum())
    assert noisy < 0.01 * sum(a.size for a in after), noisy


def test_eval_step_matches_jax():
    """Forward-only loss with the model in eval mode and fixed draws: within
    1e-5 relative of the JAX eval step; the model's mode is restored."""
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(num_labels=NUM_LABELS)
    jax_model = JaxMask2Former(jax_cfg)
    params = _noisy(init_params(jax_model, jax_cfg, seed=0, image_hw=IMAGE_HW), seed=3)
    batch, key = _batch(22), jax.random.PRNGKey(5)
    want = jax_make_eval_step(jax_model, jax_cfg)(params, batch, key)

    cfg = Mask2FormerConfig.tiny_test(num_labels=NUM_LABELS)
    model = Mask2Former(cfg).train()
    model.load_state_dict(params_from_jax(params), strict=True)
    got = make_eval_step(model, cfg)(to_device(batch, 'cpu'),
                                     JaxDraws(key, cfg.decoder_layers, 2, 8,
                                              cfg.train_num_points))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert model.training and not got.requires_grad


def test_remat_gives_equal_gradients():
    """Remat off, on and 'encoder', with drop path 0.3 drawn from one seed:
    equal losses and gradients (the drop-path masks are drawn outside the
    recomputed blocks)."""
    cfg = Mask2FormerConfig.tiny_test(
        num_labels=NUM_LABELS,
        backbone_config=SwinConfig(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 2),
                                   window_size=4, drop_path_rate=0.3))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 3, *IMAGE_HW))
                         .astype(np.float32))
    results = []
    for remat in (False, True, 'encoder'):
        torch.manual_seed(0)
        model = Mask2Former(cfg, remat=remat).train()
        if results:
            model.load_state_dict(results[0][0])
        out = model(x, torch.Generator().manual_seed(5))
        loss = (out.masks_queries_logits ** 2).mean() + (out.class_queries_logits ** 2).mean()
        loss.backward()
        results.append((model.state_dict(), float(loss),
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    for _, loss, grads in results[1:]:
        assert loss == results[0][1]
        for name, g in grads.items():
            torch.testing.assert_close(g, results[0][2][name], atol=1e-6, rtol=1e-5, msg=name)
    # the draw mattered: another seed drops other paths
    model = Mask2Former(cfg).train()
    model.load_state_dict(results[0][0])
    out = model(x, torch.Generator().manual_seed(6))
    other = float((out.masks_queries_logits ** 2).mean() + (out.class_queries_logits ** 2).mean())
    assert other != results[0][1]


class _SynthRaw:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        h, w = (40, 56) if i % 2 else (48, 48)
        masks = (rng.random((i % 3 + 1, h, w)) > 0.6).astype(np.uint8)
        return {'pixel_values': rng.standard_normal((3, h, w)).astype(np.float32),
                'mask_labels': masks, 'class_labels': rng.integers(0, 4, len(masks)),
                'target_size': (h, w), 'original_map': rng.integers(0, 9, (h, w)),
                'id_to_semantic': {j + 1: j % 2 for j in range(len(masks))},
                'file_name': f'img_{i:03d}.png'}


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_npz_cache_reads_back_across_packages(tmp_path, writer):
    """A cache written by either package's ``process_and_save`` reads back
    identically through both, with the same pad size and static batches."""
    write = (jax_dataset_utils if writer == 'jax' else dataset_utils).process_and_save
    write(_SynthRaw(5), str(tmp_path))
    ours = dataset_utils.PreprocessedDataset(str(tmp_path))
    theirs = jax_dataset_utils.PreprocessedDataset(str(tmp_path))
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    pad = dataset_utils.compute_static_pad_hw([str(tmp_path)])
    assert pad == jax_dataset_utils.compute_static_pad_hw([str(tmp_path)]) == ((64, 64), 3)

    keyed = dataset_utils.PreprocessedDataset(str(tmp_path), keys=dataset_utils.TRAIN_SAMPLE_KEYS)
    collate = dataset_utils.make_train_collate(pad[0], pad[1], 2)
    want_collate = jax_dataset_utils.make_train_collate(pad[0], pad[1], 2, wire=False)
    loader = DataLoader(keyed, 2, collate, shuffle=True, seed=3)
    batches = list(loader)
    assert len(batches) == len(loader) == 3
    order = np.arange(5)
    np.random.default_rng(3).shuffle(order)
    for got, idx in zip(batches, [order[:2], order[2:4], order[4:]]):
        want = want_collate([keyed[int(i)] for i in idx])
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert batches[-1]['sample_valid'].tolist() == [1.0, 0.0]


def test_state_dict_to_jax_round_trip():
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(num_labels=NUM_LABELS)
    params = _noisy(init_params(JaxMask2Former(jax_cfg), jax_cfg, seed=0, image_hw=IMAGE_HW), 2)
    sd = params_from_jax(params)
    tree = state_dict_to_jax(sd)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    back = params_from_jax(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
