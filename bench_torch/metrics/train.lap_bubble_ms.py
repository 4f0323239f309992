"""Device ms a micro-step of the window between the timing events of the program's
span ``lap.bubble``: on the stream only the LAP's two small copies lie between
them, so this is the device idle the host round trip opens."""

from bench_torch.program_spans import device_ms_per_micro_step


def read(run):
    return device_ms_per_micro_step(run, 'lap.bubble')
