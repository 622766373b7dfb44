"""The plain reference of the ViTDet cell: ViTDet Cascade Mask R-CNN
(detectron2's ``projects/ViTDet``: a plain ViT with decomposed relative
positions and stochastic depth, the simple feature pyramid, a two-conv RPN
head, three cascade box stages and a mask head with channel LayerNorm), its
seeded init and AdamW with ViT layer-wise lr decay, in plain tensor
operations: attention written out as ``softmax(q k^T * s + bias) v``, no
fused attention, no custom op. It imports nothing of the port and nothing
of JAX; it takes the box coder, the matcher, the sampling, the proposal
stage, the pooler's plain twin and the losses from ``portbench.refmodel``,
whose files it does not change.

Departures from detectron2, each also the port's and each named where it is
made: the seeded init (``init``), ``pos_embed`` learned at the grid of the
run's input (no ``get_abs_pos`` interpolation from MAE's 14 x 14 table),
bf16 products with f32 norms, softmax and residual stream in place of fp16
AMP (``vit``), and the port's fixed-capacity RPN and ROI heads
(``portbench.refmodel``).
"""
