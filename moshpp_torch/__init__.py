"""MoSh++ on PyTorch and CUDA: the port of `moshpp_tpu` to an NVIDIA H100,
with hand-written Hopper kernels in `csrc/`.

Layer map (bottom-up), as in the JAX package:
  kernels/   nvcc build, ctypes load and launch counts of csrc/
  ops/       geometry ops (rodrigues, knn, point-mesh distance, local-frame
             marker transforms, rigid alignment, robustifiers, the marker
             kernels' wrappers)
  models/    SMPL-family, SMAL and rigid-object forward models
  priors/    pose and shape priors (max-mixture GMM, Mahalanobis)
  solver/    batched dogleg trust-region Gauss-Newton, the PCG direction
  io/        mocap and model I/O, AMASS export
  markers/   marker-layout tables and layout file tooling
  pipeline/  stage i, stage ii, the head, frame pickers, jobs, the fleet
  parallel/  stage ii sharded over devices and over processes

This package imports torch and never JAX.
"""
