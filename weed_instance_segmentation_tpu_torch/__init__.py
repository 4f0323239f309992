"""PyTorch/CUDA port of ``weed_instance_segmentation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
the name and location of its JAX counterpart. This package imports torch and
numpy only: never jax, flax, PIL or the JAX package itself, so it runs on a
machine that has only PyTorch and the CUDA toolkit.

- ``models``     — Mask2Former: Swin backbone, deformable-attention pixel
  decoder, masked-attention transformer decoder; ``convert`` loads the JAX
  package's flax params.
- ``ops``        — resize primitives, deformable attention, and the hand-written
  CUDA kernels (sources in ``csrc/``, built on first use into ``build/``).
- ``processing`` — fused uint8 pre-process and instance post-process.
- ``engine``     — model construction and the serving function.
"""
