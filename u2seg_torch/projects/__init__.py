"""Project heads and recipes of the u2seg_torch port (counterpart of
``u2seg_tpu/projects/``): ordinary subpackages that the model code imports
where a config asks for them, or that a caller composes with a model of the
port (as ``chip_smoke.py`` does).

  deeplab           DeepLabV3(+) semantic heads over ASPP, hard pixel mining
  panoptic_deeplab  box-free panoptic heads (centres and offsets), grouping
                    and fusion
  rethinking_bn     the head-BN variants of "Rethinking Batch in BatchNorm"
  pointrend         point-sampled mask refinement (PointRend)
  pointsup          point-supervised mask loss (PointSup)
  tridentnet        weight-shared multi-dilation trident blocks
  tensormask        dense sliding-window masks and SwapAlign2Nat (TensorMask)
  densepose         DensePose chart heads, losses and IUV inference
  densepose_cse     DensePose continuous surface embeddings
  densepose_data    COCO-DensePose annotations -> fixed arrays, the mapper
  densepose_eval    DensePose mask-IoU evaluation
"""
