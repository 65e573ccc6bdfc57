"""pomfret_tpu_torch — the PyTorch/CUDA port of pomfret_tpu.

The host layers are copies of pomfret_tpu's: io/ (the BGZF/BAM/CRAM stack
and the native C++ IO library, built into io/native/_build/), core/ (the
host oracle among them), utils/, the data makers of testing.py and the host
parts of pipeline.py and cli.py. The device engine is written for torch
tensors on an explicit `device`, with the greedy-loop kernels hand-written
in CUDA C++ for Hopper (kernels/csrc). Module names mirror pomfret_tpu's,
so each module's counterpart is easy to find. Nothing here imports jax or
pomfret_tpu.
"""
from __future__ import annotations

from typing import Optional, Tuple

__version__ = "0.1.0"

VERSION = "v0.1-torch-r1"

ENGINES = ("auto", "host", "torch", "cuda")


def resolve_device(engine: str, device: Optional[str] = None
                   ) -> Tuple[str, Optional["torch.device"]]:
    """Map a CLI engine name to (engine, device).

    - "cuda": the hand-written kernel; needs a card, raises otherwise.
    - "torch": the plain PyTorch loop on `device` (default: the CPU).
    - "host": the host oracle (core.engine_host); no device.
    - "auto": "cuda" when a card is present, else "host" (logged).
    """
    import torch
    from .utils.log import log_info

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if engine == "auto":
        engine = "cuda" if torch.cuda.is_available() else "host"
        log_info("resolve_device", f"engine auto -> {engine}")
    if engine == "host":
        return "host", None
    if engine == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--engine cuda needs a CUDA device, and "
                               "torch.cuda.is_available() is False")
        dev = torch.device(device or "cuda")
        if dev.type != "cuda":
            raise ValueError(f"--engine cuda cannot run on device {dev}")
        return "cuda", dev
    return "torch", torch.device(device or "cpu")
