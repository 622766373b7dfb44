"""Project heads and recipes of the u2seg_torch port (counterpart of
``u2seg_tpu/projects/``): ordinary subpackages that the model code imports
where a config asks for them.

  deeplab           DeepLabV3(+) semantic heads over ASPP, hard pixel mining
  panoptic_deeplab  box-free panoptic heads (centres and offsets), grouping
                    and fusion
  rethinking_bn     the head-BN variants of "Rethinking Batch in BatchNorm"
"""
