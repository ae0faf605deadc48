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
- ``serving/`` — request queue, tenancy, radix KV cache, host KV tier,
  n-gram speculation, the continuous-batching engines and the
  disaggregated prefill/decode engines (``serving/disagg``);
- ``gateway/`` — the serving fleet: routing, health, autoscaling, the
  global KV index, the gateway fronts; ``channels/kv_transfer.py`` —
  the KV export format and in-process transport;
- ``service/inference.py`` — the build functions that return a started
  engine or a gateway over a fleet of them;
- ``parallel/train.py`` and ``train.py`` — the train step, AdamW, MFU,
  and ``python -m lzy_tpu_torch.train``;
- the workflow SDK, each a trimmed copy of its ``lzy_tpu`` counterpart:
  ``core/`` (``@op``, ``Lzy``, ``Lzy().workflow()``, call signatures),
  ``runtime/`` (the in-process ``LocalRuntime``), ``snapshot/``,
  ``storage/`` (``file://``, ``mem://``), ``proxy/`` (lazy results),
  ``env/`` (environment variables), ``whiteboards/``, ``types.py`` and
  ``serialization/``, where ``torch_ser.py`` takes the place of
  ``jax_ser.py``: the reference's ``LZYA`` tensor layout byte for byte,
  and a tree format of its own for ``state_dict``-like values;
- the in-process cluster behind the remote runtime, each a trimmed copy
  too: ``durable/`` (the SQLite operation store, the step runner),
  ``service/`` (allocator, thread VMs, worker agents, graph executor,
  workflow service, ``InProcessCluster``), ``channels/manager.py``
  (storage and device-resident peers), ``env/provisioning.py`` and
  ``runtime/remote.py``;
- the llm-op surface: ``llm/`` (``llm.generate`` as a cached op,
  ``Conversation``, ``Generation``, the workflow scheduler with in-flight
  dedup, fused op chains and speculative next-step prefill, generation
  whiteboards), ``channels/token_stream.py`` (token streams with a
  storage spill) and ``utils/backoff.py``.

The package imports ``torch`` and numpy only: never JAX, ``ml_dtypes``
or anything of ``lzy_tpu`` (``cloudpickle`` only inside the pickle
fallback, if installed). Its metrics, fault points and logger live in its OWN
registries (``utils/metrics.REGISTRY``, ``chaos/faults.CHAOS``), so
importing the port leaves the reference's process-global state alone.
CUDA-only work (building and loading the kernels) happens at first use,
never at import.
"""

from lzy_tpu_torch.core.lzy import Lzy, lzy_auth
from lzy_tpu_torch.core.op import op
from lzy_tpu_torch.device import resolve_device
from lzy_tpu_torch.env.environment import LzyEnvironment
from lzy_tpu_torch.env.provisioning import Provisioning
from lzy_tpu_torch.types import VmSpec
from lzy_tpu_torch.whiteboards.decl import whiteboard
from lzy_tpu_torch import llm

__all__ = ["Lzy", "lzy_auth", "op", "resolve_device", "LzyEnvironment",
           "Provisioning", "VmSpec", "whiteboard", "llm"]
