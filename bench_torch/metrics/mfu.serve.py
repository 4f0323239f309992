"""Model FLOPs of an image's forward times the window's images a second, over
the bf16 peak."""

from bench_torch.readers import mfu


def read(run):
    return mfu(run, 'serve_img_per_s', 1, 'bfloat16')
