"""The plain reference of the benchmark: a frozen copy of the port's R50-FPN
Panoptic FPN (backbone, FPN, RPN, Standard and Cascade ROI heads, mask and
sem-seg heads, fusion), its seeded init and its optimizer, in plain tensor
operations. It imports nothing of the port: the pooler kernels are replaced
by their plain twin (``roi_align_ml``), SyncBN by BN over this process's
batch, and nothing is registered as a custom op. Later changes to the port
leave it as it is, so it keeps computing what the port computed when the
benchmark was written.
"""
