"""lzy_tpu_torch: the PyTorch/CUDA port of lzy_tpu, slice by slice.

A second package beside ``lzy_tpu`` (the JAX reference, which stays as
it is). It serves Llama from a paged KV pool through a hand-written
paged-attention kernel for Hopper (``csrc/paged_attention.cu``) and
trains it through hand-written flash-attention kernels
(``csrc/flash_attention.cu``), and mirrors the reference's layout so
every module has a named counterpart:

- ``models/llama.py``, ``models/generate.py``, ``models/common.py`` —
  the model with its causal-LM loss, and the greedy/sampled
  ``generate()`` oracle;
- ``ops/paged_attention.py``, ``ops/flash_attention.py`` — the plain
  PyTorch versions and the CUDA kernels' wrappers; ``ops/attention.py``
  and ``ops/chunked_ce.py`` — plain attention and the chunked CE;
- ``serving/`` — request queue, tenancy, radix KV cache, n-gram
  speculation and the continuous-batching engines;
- ``service/inference.py`` — the builder that returns a started engine;
- ``parallel/train.py`` and ``train.py`` — the train step, AdamW, MFU,
  and ``python -m lzy_tpu_torch.train``.

The package imports ``torch`` and numpy only: never JAX and nothing of
``lzy_tpu``. Its metrics, fault points and logger live in its OWN
registries (``utils/metrics.REGISTRY``, ``chaos/faults.CHAOS``), so
importing the port leaves the reference's process-global state alone.
CUDA-only work (building and loading the kernels) happens at first use,
never at import.
"""

from lzy_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
