"""What the per-layer metric files share: rooflines of operator calls in
the traced slice, device and host time by range, model FLOP utilisation.

A reader returns ``None`` where its slice holds nothing to read, and never
a share of 0 for a roofline or a peak."""

from __future__ import annotations

from bench_torch import roofline
from bench_torch.spans import MSDA_BACKWARD, MSDA_RANGE

DTYPES = {'c10::BFloat16': 'bfloat16', 'c10::Half': 'float16', 'float': 'float32'}


def _outermost(ranges: list) -> list:
    """Drop ranges inside an earlier one of the same name on the same
    thread (an operator that redispatches records itself again)."""
    out, ends = [], {}
    for r in ranges:
        a, b, name, tid, _ = r
        if ends.get((name, tid), -1) >= b:
            continue
        ends[(name, tid)] = b
        out.append(r)
    return out


def op_work(run, op: str, work) -> float:
    """Least seconds of every call of operator ``op`` in the slice:
    ``work(dims, dtype)`` gives a call's (bytes, FLOPs)."""
    total = 0.0
    for *_, args in _outermost(run.slice.ranges_named(op)):
        dims = args.get('Input Dims', [])
        dtype = DTYPES.get(args.get('Input type', [''])[0], 'float32')
        moved, flops = work(dims, dtype)
        total += roofline.bound_s(moved, flops, dtype)
    return total


def op_roofline(run, ops: dict) -> float | None:
    """Share (%) of the least time over the device time of the kernels the
    calls of ``ops`` ({operator: work}) launched."""
    if run.slice is None:
        return None
    least = sum(op_work(run, op, work) for op, work in ops.items())
    busy = run.slice.device_s(lambda n: n in ops, same_thread=True)
    if least <= 0 or busy <= 0:
        return None
    return 100.0 * least / busy


def window_fwd(dims, dtype):
    nw, heads, t, d = dims[0]
    mask = dims[4] if len(dims) > 4 else []
    return roofline.window_attention(nw, heads, t, d, dtype, bool(mask),
                                     mask[0] if mask else 0)


def window_bwd(dims, dtype):
    nw, heads, t, d = dims[0]
    mask = dims[6] if len(dims) > 6 else []
    return roofline.window_attention(nw, heads, t, d, dtype, bool(mask),
                                     mask[0] if mask else 0, backward=True)


def masked_fwd(dims, dtype):
    b, heads, nq, d = dims[0]
    return roofline.masked_attention(b, heads, nq, dims[1][2], d, dtype)


def masked_bwd(dims, dtype):
    b, heads, nq, d = dims[0]
    return roofline.masked_attention(b, heads, nq, dims[1][2], d, dtype, backward=True)


def postprocess(dims, dtype):
    return roofline.postprocess(*dims[0])


WINDOW = {'wistpu::window_attention_fwd': window_fwd, 'wistpu::window_attention_bwd': window_bwd}
MASKED = {'wistpu::masked_attention_fwd': masked_fwd, 'wistpu::masked_attention_bwd': masked_bwd}
POSTPROCESS = {'wistpu::fused_upsample_stats': postprocess}


def msda_roofline(run) -> float | None:
    """Share (%) of MSDA's least time (each sampling call, and its
    backward where one follows) over the device time of the work launched
    in the benchmark's range around each call and in the call's autograd
    node."""
    calls = getattr(run.slice, 'msda_calls', None) if run.slice is not None else None
    if not calls:
        return None
    least = 0.0
    for value, dtype, loc, coord_dtype, shapes, backward in calls:
        b, rows, heads, d = value
        _, q, _, levels, points, _ = loc
        for bwd in (False, True) if backward else (False,):
            least += roofline.bound_s(*roofline.msda(b, q, heads, levels, points, d, rows,
                                                     dtype, coord_dtype, bwd), dtype)
    busy = run.slice.device_s(lambda n: n == MSDA_RANGE or n.endswith(MSDA_BACKWARD))
    return 100.0 * least / busy if busy > 0 else None


def device_ms_per_unit(run, match, same_thread: bool = False) -> float | None:
    if run.slice is None:
        return None
    ms = 1e3 * run.slice.device_s(match, same_thread) / run.slice.units
    return ms if ms > 0 else None


def host_ms_per_unit(run, match) -> float | None:
    if run.slice is None or not run.slice.ranges_named(match):
        return None
    return 1e3 * run.slice.host_s(match) / run.slice.units


def idle_share(run) -> float | None:
    return None if run.slice is None else 100.0 * run.slice.idle_share()


def mfu(run, rate_key: str, passes: int, dtype: str) -> float | None:
    """Model FLOPs an image (``passes`` forwards' worth) times the window's
    images a second, over the peak of ``dtype``, in %."""
    rate = run.window.get(rate_key)
    if not rate:
        return None
    t = run.traffic
    flops = passes * roofline.model_flops(run.config, *t['model_hw' if 'model_hw' in t
                                                          else 'image_hw'])
    return 100.0 * flops * rate / roofline.PEAK_FLOPS[dtype]
