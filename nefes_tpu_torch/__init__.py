"""nefes_tpu_torch — the PyTorch and CUDA port of nefes_tpu, for one NVIDIA
H100 (Hopper, sm_90a).

The layout mirrors nefes_tpu so that each module's counterpart is found by
name; the JAX package is the reference every module is tested against.
This package imports torch, numpy and the standard library only.

  geometry/   SE(3) exp-map pose deltas, SVD (and, capturable, polar)
              re-orthogonalisation, pinhole rays, world setup and the
              dataset-frame alignments (dSLAM, COLMAP, Cambridge)
  fields/     frequency embedding, NeRFH-NFF field, exposure MLP,
              FusionNet; the zoo's fields: the instant-ngp hash grid
              (NeRFHTcnn), NeRF-W and plain NeRF, the GIRAFFE decoder
  features/   DFNet (VGG16 hypercolumn features + pose regressor, f32 or
              bf16); the reference's torch checkpoints (NeFeS .tar, DFNet,
              the tcnn hash-grid buffers) converted to the port's state
              dicts
  render/     stratified + inverse-CDF sampling, compositor, renderer
  kernels/    hand-written Hopper kernels (csrc/) with their plain PyTorch
              versions: the fused field (modes sigma / full / transient,
              backward with or without weight gradients) and the
              composite-fused fine render, each on pre-embedded inputs
              (K1-K4) and on raw points and directions embedded in the
              kernel (K5-K8)
  train/      ModelConfig, the NeFeSModel bundle; field training: the
              random-ray (stages 0/1) and patch (stage 2) steps, schedule,
              optax-style Adam, the NeRF-W / feature / fusion losses,
              torch.save checkpoints; the field zoo (field_zoo.py)
  refine/     mode-3 pose refinement (explicit SE(3) delta + Adam) and
              mode-2 APR refinement (Adam on DFNet's weights, with the
              PSNR/SSIM verification fail-safe): the eager loops, and the
              serving functions that on the card replay one captured
              iteration as a CUDA graph (graph.py)
  utils/      torch-semantics bicubic / bilinear resizes, SSIM
  data/       SceneData, luminance histograms, the synthetic blob scene,
              the 7-Scenes (dSLAM, COLMAP) and Cambridge loaders, image
              reading (images.py: Pillow + OpenCV)
  evaluation/ pose errors, accuracy buckets, pose txts, ATE, the
              paper-result golden files
  cli/        Options and the reference's config txts, the scene and model
              builders, the refinement CLI (python -m
              nefes_tpu_torch.cli.refine) and the evaluation CLI

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
