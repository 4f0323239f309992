"""What the per-layer metrics of the program's own spans share: the spans
the program recorded (``weed_instance_segmentation_tpu_torch/engine/
trace.py``) inside the untraced window, ``[t0 + setup_s, t0 + setup_s +
elapsed_s]`` on the clock the window is timed with
(``time.perf_counter``), over the window's micro-steps.

A program without the recorder, or a window in which it recorded none of
the spans asked for, reads ``None``."""

from __future__ import annotations


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from weed_instance_segmentation_tpu_torch.engine import trace
    except ImportError:
        return None
    return trace


def window_spans(run, name: str) -> list:
    """The spans named ``name`` that lie inside the window."""
    trace = recorder()
    if trace is None or run.setup_s is None or 'elapsed_s' not in run.window:
        return []
    start = run.t0 + run.setup_s
    return [s for s in trace.spans(start, start + run.window['elapsed_s']) if s.name == name]


def host_ms_per_micro_step(run, name: str) -> float | None:
    """Host ms a micro-step of the window in the spans ``name``."""
    found, steps = window_spans(run, name), run.window.get('micro_steps')
    if not found or not steps:
        return None
    return 1e3 * sum(s.seconds for s in found) / steps


def host_ms_per_span(run, name: str) -> float | None:
    """Host ms of one span ``name`` of the window, on average."""
    found = window_spans(run, name)
    return 1e3 * sum(s.seconds for s in found) / len(found) if found else None


def device_ms_per_micro_step(run, name: str) -> float | None:
    """Device ms a micro-step between the timing events of the spans
    ``name`` (every one of them read; else None)."""
    found, steps = window_spans(run, name), run.window.get('micro_steps')
    ms = [recorder().device_ms(s) for s in found]
    if not ms or not steps or None in ms:
        return None
    return sum(ms) / steps
