"""Native (C++) runtime components, ctypes-bound.

The runtime-side pieces that are native in the reference too (plasma allocator et al.). Build is
on-demand and cached: g++ compiles each .cpp once per source hash into
RAY_TPU_TORCH_NATIVE_CACHE (default ~/.cache/ray_tpu_torch_native). Every consumer
has a pure-Python fallback, so a missing toolchain degrades, never
breaks.
"""

from ray_tpu_torch._native.build import load_library, native_available  # noqa: F401
