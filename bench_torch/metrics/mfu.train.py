"""Model FLOPs of an image's forward and backward (three forwards; remat's
recompute not counted) times the window's images a second, over the bf16 peak."""

from bench_torch.readers import mfu


def read(run):
    return mfu(run, 'train_img_per_s', 3, 'bfloat16')
