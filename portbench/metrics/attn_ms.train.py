"""Device ms per traced training step in ViT attention, the whole block in
both directions. Forward: the kernels launched inside the program's
``u2s.vit.attn.window`` and ``u2s.vit.attn.global`` spans (window padding,
qkv, the relative-position bias, the fused attention, proj), found by each
kernel's launch. Backward: the kernels launched while the autograd engine
evaluated a node made by those spans' ops (the trace's ``attn_backward``,
linked by sequence number): the fused attention's backward, the sums of
the bias gradient, the rel-pos terms', qkv's and proj's backward. Both take
the kernels that start inside the traced window. None where the trace
holds no such span or no such node (a program without them)."""
import bisect

from portbench import spantrace

SPANS = "u2s.vit.attn."


def read(record):
    tr = getattr(record, "trace", None)
    if (record.kind != "train" or not isinstance(tr, spantrace.ProgramTrace)
            or not record.traced_steps):
        return None
    nodes = sorted(getattr(tr, "attn_backward", ()))
    starts = [s for s, _ in nodes]
    label = tr.labeller()
    lo, hi = tr.window
    forward = backward = 0
    for launch, s, e, kernel in tr.launches:
        if not kernel or not lo <= s < hi:
            continue
        if label(launch).startswith(SPANS):
            forward += e - s
        else:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch < nodes[i][1]:
                backward += e - s
    if forward <= 0 or backward <= 0:
        return None
    return (forward + backward) * 1e-6 / record.traced_steps
