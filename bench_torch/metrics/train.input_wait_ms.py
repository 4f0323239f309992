"""Host ms a micro-step of the window waits for its batch from the input path (the
benchmark's clock around ``next()`` on the feed)."""

def read(run):
    w = run.window
    return 1e3 * w['input_wait_s'] / w['micro_steps'] if w.get('micro_steps') else None
