"""lzy_tpu_torch: the PyTorch/CUDA port of lzy_tpu's serving main path.

A second package beside ``lzy_tpu`` (the JAX reference, which stays as
it is). It serves Llama from a paged KV pool through a hand-written
paged-attention kernel for Hopper (``csrc/paged_attention.cu``), and
mirrors the reference's layout so every module has a named counterpart:

- ``models/llama.py``, ``models/generate.py`` — the model and the
  greedy/sampled ``generate()`` oracle;
- ``ops/paged_attention.py`` — int8 KV quantization, the plain PyTorch
  paged attention and the CUDA kernel's wrapper;
- ``serving/`` — request queue, tenancy, radix KV cache, n-gram
  speculation and the continuous-batching engines;
- ``service/inference.py`` — the builder that returns a started engine.

The package imports ``torch`` and numpy only: never JAX and nothing of
``lzy_tpu``. Its metrics, fault points and logger live in its OWN
registries (``utils/metrics.REGISTRY``, ``chaos/faults.CHAOS``), so
importing the port leaves the reference's process-global state alone.
CUDA-only work (building and loading the kernel) happens at first use,
never at import.
"""

from lzy_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
