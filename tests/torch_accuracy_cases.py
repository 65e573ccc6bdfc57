"""Shared by tests/test_torch_accuracy*.py: the small dense chromosome, the
JAX accuracy tool loaded from its file, and the allocator setting the
port's plain loop needs on the CPU at the dense shape."""
import contextlib
import ctypes
import importlib.util
import os

from pomfret_tpu_torch.testing import cached_dataset, dense_params
import torch_jax_native

torch_jax_native.ready()  # the JAX package's native library, built once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# glibc mallopt parameters (malloc.h) and their defaults
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_DEFAULT_THRESHOLD = 128 * 1024


def small_dense(root):
    """(bam, vcf, gaps, seconds) of dense_params(0.05) cut to 3 blocks:
    read stagger 180 (~200x), noise 0.05, nocall 0.05, 2 gaps, made under
    <root>/.bench_data/."""
    return cached_dataset(str(root), dict(dense_params(0.05), n_blocks=3),
                          "dense_noise.bam")


def jax_tool():
    """tools/accuracy_scale.py, the JAX engine's accuracy tool."""
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_scale", os.path.join(REPO, "tools", "accuracy_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def heap_returned():
    """glibc's default mmap and trim thresholds while the block runs. Both
    packages' native IO loaders raise them to 1 GiB (utils/malloc_tune.py);
    under that setting the plain loop's per-iteration temporaries at
    R=1792, S=1536 fragment the heap to ~11 GiB of RSS on the CPU, against
    ~0.9 GiB with the defaults. Restored on exit where a loader had
    raised them."""
    from pomfret_tpu.utils import malloc_tune as jax_tune
    from pomfret_tpu_torch.utils import malloc_tune as port_tune
    libc = ctypes.CDLL(None)
    for param in (_M_MMAP_THRESHOLD, _M_TRIM_THRESHOLD):
        libc.mallopt(param, _DEFAULT_THRESHOLD)
    try:
        yield
    finally:
        if jax_tune._done or port_tune._done:
            for param in (_M_MMAP_THRESHOLD, _M_TRIM_THRESHOLD):
                libc.mallopt(param, 1 << 30)
