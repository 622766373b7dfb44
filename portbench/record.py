"""What a run leaves for the metric readers: its times, counts, trace and
the outcome of the comparison with the reference."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from portbench.devtrace import Trace


@dataclass
class Record:
    kind: str                                  # the traffic's drivers/ module: "train"
    setup_s: float                             # process start -> first timed unit
    window_s: float                            # the measured window, host clock
    images: int                                # images completed in the window
    steps: int                                 # steps (batches) in the window
    attempted: int
    failed: int
    memory_peak_bytes: int
    correct: bool = False
    checks: Dict[str, dict] = field(default_factory=dict)
    data_wait_s: List[float] = field(default_factory=list)   # per window step
    # the traced part of the window (``--trace 1``)
    trace: Optional[Trace] = None
    traced_steps: int = 0
    # the window's untraced steps (a traced run's others), host clock, and
    # the reference's count of their work
    untraced_s: float = 0.0
    untraced_steps: int = 0
    untraced_flops: Optional[float] = None
    compute_dtype: str = "bfloat16"            # the configuration's products
    k3_bytes: float = 0.0                      # least bytes of the traced K3 calls
    k3_calls: int = 0
    # what the comparison read, for the calibration tools (not a metric)
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def busy_s(self) -> Optional[float]:
        return None if self.trace is None else self.trace.busy_s

    @property
    def traced_s(self) -> Optional[float]:
        return None if self.trace is None else self.trace.window_s

    @property
    def breakdown(self) -> Optional[dict]:
        if self.trace is None:
            return None
        return {"device_ops": self.trace.top_kernels(), "idle_gaps": self.trace.idle_gaps()}
