"""Environment and reproducibility (counterpart of ``u2seg_tpu/utils/env.py``,
after ``detectron2/utils/env.py`` seed_all_rng :27 and ``collect_env.py``
collect_env_info :55)."""
from __future__ import annotations

import datetime
import os
import random
import subprocess
import sys
from typing import Optional

import numpy as np
import torch


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed python, numpy and torch (every device's generator). A seed that
    is None or negative is drawn from the pid, the clock and urandom.
    Returns the seed used."""
    if seed is None or seed < 0:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        ) % (2 ** 31)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unavailable"
    except (OSError, subprocess.SubprocessError):
        return "unavailable"


def collect_env_info() -> str:
    """Versions, the card and the port's native libraries, one per line. The
    last lines say for each ``csrc/*.cu`` whether its library is built at
    ``_cuda.library_path(name)``, and whether the host matcher of
    ``u2seg_torch/_native`` is (the JAX package prints its
    ``_native.available()``)."""
    from u2seg_torch import _cuda, _native

    lines = [
        f"sys.platform: {sys.platform}",
        f"Python: {sys.version.replace(os.linesep, ' ')}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__}",
        f"torch CUDA: {torch.version.cuda}",
        f"CUDA available: {torch.cuda.is_available()}",
    ]
    if torch.cuda.is_available():
        lines.append(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
        lines.append(f"nvidia-smi name, power limit: {_smi()}")
    try:
        lines.append(f"nvcc: {_cuda._nvcc()}")
    except RuntimeError as e:
        lines.append(f"nvcc: unavailable ({e})")
    for src in sorted(f for f in os.listdir(_cuda.CSRC_DIR) if f.endswith(".cu")):
        name = src[:-3]
        path = _cuda.library_path(name)
        lines.append(f"kernel {name}: {'built' if os.path.exists(path) else 'not built'} ({path})")
    try:
        path = _native.library_path()
        lines.append(f"native rle_ops: {'built' if os.path.exists(path) else 'not built'} ({path})")
    except RuntimeError as e:
        lines.append(f"native rle_ops: unavailable ({e})")
    return "\n".join(lines)
