"""u2seg_torch: the PyTorch/CUDA port of u2seg_tpu.

A package of its own beside the JAX package (which stays the reference): the
same config tree and YAML files, detectron2 module names, and the JAX
package's layouts at public functions. It imports torch and numpy, never
JAX or anything of ``u2seg_tpu``. The multilevel FPN ROIAlign, forward and
backward, is a pair of hand-written CUDA kernels (``csrc/roi_align_ml.cu``)
built at first use. Inference: ``models.build.build_model`` / ``entry``,
and every buildable zoo config through ``model_zoo.get``; training:
``engine.trainer.create_train_state`` / ``make_train_step``.
"""
