"""The port's two attention ops (plain versions, float32, on the CPU) against
the JAX package: outputs and gradients.

The JAX side is the XLA formulation that each Pallas A/B harness holds its
kernel to (``tools/ab_window_attn.py::xla_window_attention``,
``tools/ab_masked_attn.py::xla_masked_attention``), imported by path, and the
JAX ``WindowAttention`` module for the shifted-window mask. Inputs are seeded
numpy arrays given to both.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.swin import WindowAttention as JaxWindowAttention

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.models.configuration import SwinConfig
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.models.swin import (
    WindowAttention, shifted_window_attn_mask, window_partition,
)
from weed_instance_segmentation_tpu_torch.ops.masked_attention import (
    BACKWARD_LAUNCHES as MASKED_BACKWARD_LAUNCHES, LAUNCHES as MASKED_LAUNCHES, masked_attention,
    masked_attention_plain,
)
from weed_instance_segmentation_tpu_torch.ops.window_attention import (
    BACKWARD_LAUNCHES as WINDOW_BACKWARD_LAUNCHES, LAUNCHES as WINDOW_LAUNCHES, window_attention,
    window_attention_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('nw,heads,tokens,head_dim', [(6, 2, 16, 16), (4, 3, 36, 32)])
def test_window_attention_matches_xla(nw, heads, tokens, head_dim):
    """Output within 1e-5 and d(q, k, v, bias) within 1e-5 of ``jax.grad``
    of the XLA formulation, for a random cotangent."""
    xla = _tool('ab_window_attn').xla_window_attention
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((nw, heads, tokens, head_dim)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((heads, tokens, tokens)).astype(np.float32)
    cot = rng.standard_normal((nw, heads, tokens, head_dim)).astype(np.float32)

    want, vjp = jax.vjp(xla, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(cot))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    got = window_attention(*ts)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, w in zip('qkvb', ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


@pytest.mark.parametrize('seq', [40, 7])
def test_masked_attention_matches_xla(seq):
    """Output within 1e-5 and d(q, k, v) within 1e-5 of ``jax.grad`` of the
    XLA formulation with the additive −1e9 bias; 70 % of the scores masked,
    with the decoder's all-masked-row escape."""
    xla = _tool('ab_masked_attn').xla_masked_attention
    rng = np.random.default_rng(1)
    b, heads, nq, d = 2, 2, 10, 16
    q = (rng.standard_normal((b, heads, nq, d)) * d ** -0.5).astype(np.float32)
    k, v = (rng.standard_normal((b, heads, seq, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((b, 1, nq, seq)) < 0.7
    mask[:, :, 0] = True  # a fully masked row, before the escape
    mask &= ~mask.all(-1, keepdims=True)
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    cot = rng.standard_normal((b, heads, nq, d)).astype(np.float32)

    want, vjp = jax.vjp(lambda q_, k_, v_: xla(q_, k_, v_, jnp.asarray(bias)),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = masked_attention(*ts, torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, t, w in zip('qkv', ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_window_attention_module_with_shift_mask_matches_jax():
    """The port's WindowAttention (the kernel op's plain version inside) with
    the shifted-window mask against the JAX module: output and input gradient
    within 1e-5; each parameter's gradient (sums over every token, the
    relative-position table's over every window too) within 1e-5 or 1e-5 of
    its largest entry, whichever is larger (the key bias takes no gradient:
    both sides give float32 noise of ~1e-6)."""
    kw = dict(embed_dim=16, window_size=4, drop_path_rate=0.0)
    dim, heads, ws, shift, hw = 32, 2, 4, 2, (8, 12)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2 * (hw[0] // ws) * (hw[1] // ws), ws * ws, dim)).astype(np.float32)
    mask = shifted_window_attn_mask(*hw, ws, shift)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    jax_module = JaxWindowAttention(jax_configuration.SwinConfig(**kw), dim, heads)
    params = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, True)['params']
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.1, np.shape(p)).astype(np.float32), params)

    def apply(p, x_):
        return jax_module.apply({'params': p}, x_, mask, True)

    want, vjp = jax.vjp(apply, params, jnp.asarray(x))
    want_params, want_x = vjp(jnp.asarray(cot))

    module = WindowAttention(SwinConfig(**kw), dim, heads)
    module.load_state_dict(params_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = module(xt, torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-5)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    for name, p in module.named_parameters():
        want_grad = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_grad, err_msg=name,
                                   atol=max(1e-5, 1e-5 * np.abs(want_grad).max()))


def test_window_mask_follows_window_partition():
    """Window w of a batch takes mask w % nW_img: the op on a 2-image batch
    equals the op on each image alone."""
    rng = np.random.default_rng(3)
    heads, ws, d = 2, 4, 16
    x = torch.from_numpy(rng.standard_normal((2, 8, 12, 3 * heads * d)).astype(np.float32))
    q, k, v = (window_partition(t, ws).reshape(-1, ws * ws, heads, d).transpose(1, 2)
               for t in x.split(heads * d, dim=-1))
    bias = torch.from_numpy(rng.standard_normal((heads, ws * ws, ws * ws)).astype(np.float32))
    mask = torch.from_numpy(shifted_window_attn_mask(8, 12, ws, 2))
    both = window_attention_plain(q, k, v, bias, mask)
    n = mask.shape[0]
    for img in range(2):
        part = slice(img * n, (img + 1) * n)
        alone = window_attention_plain(q[part], k[part], v[part], bias, mask)
        torch.testing.assert_close(both[part], alone, atol=0, rtol=0)


def test_cpu_tensors_run_the_plain_versions():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 2, 16, 16)).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros((2, 16, 16))
    launches = (trace.counter(WINDOW_LAUNCHES), trace.counter(WINDOW_BACKWARD_LAUNCHES),
                trace.counter(MASKED_LAUNCHES), trace.counter(MASKED_BACKWARD_LAUNCHES))
    assert torch.equal(window_attention(q, k, v, bias), window_attention_plain(q, k, v, bias, None))
    mask = torch.from_numpy(rng.random((4, 1, 16, 16)) < 0.5)
    mask[..., 0] = False
    assert torch.equal(masked_attention(q, k, v, mask), masked_attention_plain(q, k, v, mask))
    assert launches == (trace.counter(WINDOW_LAUNCHES), trace.counter(WINDOW_BACKWARD_LAUNCHES),
                        trace.counter(MASKED_LAUNCHES), trace.counter(MASKED_BACKWARD_LAUNCHES))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((4, 2, 16, 16))
    with pytest.raises(ValueError, match='rel_bias'):
        window_attention(q, q, q, torch.zeros((2, 16, 15)))
    with pytest.raises(ValueError, match='nW_img'):
        window_attention(q, q, q, torch.zeros((2, 16, 16)), torch.zeros((3, 16, 16)))
    with pytest.raises(ValueError, match='no kernel for device'):
        window_attention(q.to('meta'), q.to('meta'), q.to('meta'), torch.zeros((2, 16, 16),
                                                                               device='meta'))
    with pytest.raises(ValueError, match='bool'):
        masked_attention(q, q, q, torch.zeros((4, 1, 16, 16)))
    with pytest.raises(ValueError, match='B, H, Q, D'):
        masked_attention(q, q[:, :, :, :8], q, torch.zeros((4, 1, 16, 16), dtype=torch.bool))
