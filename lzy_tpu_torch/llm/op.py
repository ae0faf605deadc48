"""``llm.generate``: inference as a workflow op. The port's copy of
``lzy_tpu/llm/op.py``.

``llm.generate(prompt, ...)`` inside ``with lzy.workflow(...)`` registers
an ordinary :class:`~lzy_tpu_torch.core.call.LzyCall` whose body
dispatches to the serving plane, so its result is a typed
:class:`Generation` proxy that flows through the graph like any op
output, and ``generate -> tool op -> generate`` pipelines are plain
graphs. Outside a workflow it just runs, as an ``@op`` function does.

What riding the workflow gives a generation:

- **caching**: greedy generations cache by default, keyed on (prompt,
  params, model digest); a cached re-run never touches the fleet.
  Sampled requests opt out, and a truncated (``cancelled``) generation
  is never cached;
- **conversation affinity**: a :class:`Conversation` carried across
  steps gives the gateway router a stable session, so step N+1 lands on
  the replica whose radix cache holds steps 1..N, and the workflow
  scheduler (``llm/sched.py``) parks that KV across the tool op and
  prefills the next step's known prefix meanwhile;
- **streaming**: a ``channels.token_stream.TokenStreamChannel`` gets
  tokens as the engine emits them (in-process runtimes), and
  ``stream_spill_uri=`` mirrors them to storage for a reader elsewhere;
- **provenance**: ``record_generation`` (``llm/wb.py``) versions the
  result as a whiteboard.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

from lzy_tpu_torch.chaos.faults import CHAOS
from lzy_tpu_torch.utils.backoff import RetryPolicy
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.ids import gen_id
from lzy_tpu_torch.utils.log import get_logger

_LOG = get_logger(__name__)

#: the op name the cache namespace and graph tasks carry; the workflow
#: service and the graph executor match it
LLM_OP_NAME = "llm_generate"


class LlmDispatchError(RuntimeError):
    """Transient failure dispatching a generation to the serving plane;
    the op retries it under :data:`DISPATCH_RETRIES_POLICY`."""


# chaos boundary: one dispatch attempt to the serving plane, survivable
# by contract (the body retries with backoff; only exhausted retries
# reach the workflow)
_FP_DISPATCH = CHAOS.register(
    "llm.dispatch", error=LlmDispatchError,
    doc="one llm_op dispatch to the serving plane (retried with backoff)")

#: dispatch retry law: quick and capped (the gateway already falls back
#: across replicas within one attempt)
DISPATCH_RETRIES_POLICY = RetryPolicy(attempts=3, base_s=0.05, cap_s=1.0)


@dataclasses.dataclass
class Generation:
    """Typed result of one generation: what flows through the graph.

    ``tokens`` excludes the prompt; :meth:`full_tokens` is what a
    follow-up step feeds back as its prompt prefix. Routing and KV
    provenance fields are None outside a gateway."""

    prompt: List[int]
    tokens: List[int]
    status: str
    model: str
    model_digest: str
    params: Dict[str, Any]
    request_id: Optional[str] = None
    replica: Optional[str] = None
    routed_by: Optional[str] = None
    failovers: int = 0
    #: disagg provenance: the prefill replica whose KV the attempt USED
    prefilled_by: Optional[str] = None
    ttft_ms: Optional[float] = None
    conversation_id: Optional[str] = None
    step: Optional[int] = None
    wall_ms: Optional[float] = None

    def full_tokens(self) -> List[int]:
        return list(self.prompt) + list(self.tokens)

    def provenance(self) -> Dict[str, Any]:
        """The per-step provenance document whiteboards record."""
        return {
            "request_id": self.request_id, "status": self.status,
            "replica": self.replica, "routed_by": self.routed_by,
            "failovers": self.failovers,
            "prefilled_by": self.prefilled_by,
            "ttft_ms": self.ttft_ms, "wall_ms": self.wall_ms,
            "conversation_id": self.conversation_id, "step": self.step,
        }


class Conversation:
    """Stable session handle for multi-step pipelines, carried by value
    through every ``llm.generate`` of one conversation. The id is the
    identity: pass an explicit one when re-runs should share cache
    entries; the default is a fresh random id per object."""

    def __init__(self, conversation_id: Optional[str] = None):
        self.id = conversation_id or gen_id("conv")
        self._steps = 0

    def next_step(self) -> int:
        """Client-side step counter (called at op registration)."""
        self._steps += 1
        return self._steps

    @property
    def steps(self) -> int:
        return self._steps

    def __repr__(self) -> str:
        return f"Conversation(id={self.id!r}, steps={self._steps})"


# -- the op bodies (module-level: workers resolve them by reference) ----------

def llm_generate(prompt, gen_params, model_digest, conversation=None,
                 runtime_opts=None) -> Generation:
    """Dispatch ONE generation to the resolved serving plane (the body
    ``llm.generate`` registers, and the direct call outside a workflow).

    ``gen_params`` holds what determines the output, and so the cache
    key; ``runtime_opts`` holds operational knobs (timeouts, deadline,
    stream wiring, the workflow identity), excluded from the key."""
    from lzy_tpu_torch.llm import metrics
    from lzy_tpu_torch.llm.backend import resolve_backend
    from lzy_tpu_torch.llm.sched import scheduler_for

    backend = resolve_backend()
    sched = scheduler_for(backend)
    params = dict(gen_params)
    opts = dict(runtime_opts or {})
    step = params.pop("step", None)
    tenant = params.pop("tenant", None)
    wf_user = opts.pop("wf_user", None)
    if tenant is None:
        # a plane without IAM (the port's): the workflow identity is the
        # tenant
        tenant = wf_user
    stream, spill, spill_thread, stream_owned = _resolve_stream(opts)
    session = conversation.id if conversation is not None else None
    prompt_tokens = [int(t) for t in prompt]
    t0 = SYSTEM_CLOCK.now()

    def dispatch():
        CHAOS.hit("llm.dispatch")
        return sched.dispatch(
            prompt_tokens,
            max_new_tokens=params.get("max_new_tokens", 64),
            timeout_s=opts.get("timeout_s"),
            deadline_s=opts.get("deadline_s"),
            greedy=params.get("greedy"),
            tenant=tenant,
            priority=params.get("priority"),
            session=session,
            stream=stream)

    def retryable(e: BaseException) -> bool:
        # retry only while the stream is untouched: once a token was
        # published the consumer has seen this attempt
        if stream is not None and (stream.closed or stream.position):
            return False
        if isinstance(e, LlmDispatchError):
            return True
        from lzy_tpu_torch.rpc.core import Unavailable
        from lzy_tpu_torch.serving.scheduler import (
            AdmissionError, PromptTooLong)

        if isinstance(e, PromptTooLong):
            return False              # permanent: identical everywhere
        return isinstance(e, (AdmissionError, Unavailable))

    try:
        reply = DISPATCH_RETRIES_POLICY.call(
            dispatch, what="llm dispatch", retry_if=retryable,
            on_retry=lambda n, e: metrics.DISPATCH_RETRIES.inc())
    except BaseException as e:
        metrics.GENERATIONS.inc(status="error")
        if stream is not None and not stream.closed:
            stream.fail(f"{type(e).__name__}: {e}")
        raise
    finally:
        if spill is not None:
            _finish_spill(stream, spill, spill_thread)
        if stream_owned and stream is not None:
            # terminal by now: drop the rendezvous entry
            from lzy_tpu_torch.channels.token_stream import STREAMS

            STREAMS.release(stream.id)
    status = reply.get("status", "ok")
    tokens = list(reply.get("tokens", []))
    metrics.GENERATIONS.inc(status=status)
    metrics.GENERATED_TOKENS.inc(len(tokens))
    if session is not None and status == "ok":
        # fused op chain: park this conversation's KV and prefill the
        # next step's known prefix while the tool op runs
        sched.note_step_done(session, prompt_tokens + tokens)
    return Generation(
        prompt=prompt_tokens,
        tokens=tokens,
        status=status,
        model=reply.get("model", getattr(backend, "model_name", "custom")),
        model_digest=model_digest,
        params=dict(gen_params),
        request_id=reply.get("request_id"),
        replica=reply.get("replica"),
        routed_by=reply.get("routed_by"),
        failovers=int(reply.get("failovers", 0) or 0),
        prefilled_by=reply.get("prefilled_by"),
        ttft_ms=reply.get("ttft_ms"),
        conversation_id=session,
        step=step,
        wall_ms=round(1000 * (SYSTEM_CLOCK.now() - t0), 3),
    )


def llm_generate_batch(prompts, gen_params, model_digest, conversation=None,
                       runtime_opts=None) -> list:
    """Batch body: the prompts fan out through the scheduler's plane (one
    op node, one graph edge). Identical greedy rows dispatch once and
    every duplicate adopts a copy of the reply; each unique row still
    goes through :meth:`WorkflowScheduler.dispatch`, so in-flight dedup
    across workflows applies on top."""
    from lzy_tpu_torch.llm import metrics
    from lzy_tpu_torch.llm.backend import resolve_backend
    from lzy_tpu_torch.llm.sched import scheduler_for

    if not prompts:
        return []
    sched = scheduler_for(resolve_backend())
    dedupable = dict(gen_params).get("greedy") is True
    row_keys: List[Any] = []
    unique: Dict[Any, List[int]] = {}
    for i, p in enumerate(prompts):
        key = tuple(int(t) for t in p) if dedupable else ("row", i)
        row_keys.append(key)
        unique.setdefault(key, list(p))
    results = sched.map(
        lambda p: llm_generate(p, gen_params, model_digest,
                               conversation, runtime_opts),
        list(unique.values()))
    by_key = dict(zip(unique.keys(), results))
    out, adopted = [], set()
    for key in row_keys:
        g = by_key[key]
        if key in adopted:
            # a duplicate row adopts its twin's reply, never aliasing it
            metrics.DEDUP_HITS.inc()
            metrics.WFSCHED_DISPATCHES.inc(role="follower")
            sched.note_batch_dedup()
            g = dataclasses.replace(g, prompt=list(g.prompt),
                                    tokens=list(g.tokens),
                                    params=dict(g.params))
        adopted.add(key)
        out.append(g)
    return out


def _resolve_stream(opts):
    """In-process transport first, storage spill on top: a ``stream_id``
    resolves (or creates) the channel in the process registry; a
    ``stream_spill_uri`` also mirrors it to chunked storage objects for
    a consumer elsewhere (``StorageTokenStreamReader``)."""
    stream_id = opts.pop("stream_id", None)
    spill_uri = opts.pop("stream_spill_uri", None)
    owned = bool(opts.pop("stream_owned", False))
    if stream_id is None and spill_uri is None:
        return None, None, None, False
    from lzy_tpu_torch.channels.token_stream import (
        STREAMS, StorageTokenStreamWriter, TokenStreamChannel)

    stream = (STREAMS.get_or_create(stream_id) if stream_id is not None
              else TokenStreamChannel())
    spill = spill_thread = None
    if spill_uri is not None:
        from lzy_tpu_torch.storage import StorageConfig
        from lzy_tpu_torch.storage.registry import client_for

        spill = StorageTokenStreamWriter(
            client_for(StorageConfig(uri=spill_uri)), spill_uri)

        def mirror(ch=stream, w=spill):
            try:
                for tok in ch:
                    w.append([tok])
            except Exception:  # noqa: BLE001 — finish() records status
                pass

        spill_thread = threading.Thread(target=mirror,
                                        name="llm-stream-spill",
                                        daemon=True)
        spill_thread.start()
    return stream, spill, spill_thread, owned


def _finish_spill(stream, spill, spill_thread) -> None:
    spill_thread.join(timeout=30.0)
    try:
        if spill_thread.is_alive():
            # committing now would truncate the durable stream under an
            # "ok" manifest: a reader must see a failure instead
            spill.finish(status="error",
                         error="spill mirror stalled; durable stream "
                               "is incomplete")
            return
        spill.finish(status=stream.status or "ok", error=stream.error)
    except Exception:  # noqa: BLE001 — the reply owns the result
        _LOG.exception("token stream spill finish failed")


def _count_cache_hit() -> None:
    from lzy_tpu_torch.llm.metrics import CACHED_HITS

    CACHED_HITS.inc()


def _generation_cacheable(result) -> bool:
    """Cache veto (``core.call.result_cacheable``): only COMPLETE
    generations cache. A deadline-truncated reply (``cancelled``) would
    otherwise be served forever, since the deadline is not in the key."""
    results = result if isinstance(result, list) else [result]
    return all(isinstance(g, Generation) and g.status == "ok"
               for g in results)


#: runtime hook (``runtime/local.py``): a cached llm call never runs its
#: body, so the runtime counts the skip
llm_generate.__lzy_on_cache_hit__ = _count_cache_hit
llm_generate_batch.__lzy_on_cache_hit__ = _count_cache_hit
#: runtime hook (``core.call.result_cacheable``)
llm_generate.__lzy_result_cacheable__ = _generation_cacheable
llm_generate_batch.__lzy_result_cacheable__ = _generation_cacheable


# -- the user-facing factory --------------------------------------------------

def generate(prompt, *,
             max_new_tokens: int = 64,
             greedy: Optional[bool] = None,
             conversation: Optional[Conversation] = None,
             tenant: Optional[str] = None,
             priority: Optional[int] = None,
             deadline_s: Optional[float] = None,
             timeout_s: Optional[float] = None,
             cache: Optional[bool] = None,
             cache_version: str = "1.0",
             stream=None,
             stream_spill_uri: Optional[str] = None,
             model_digest: Optional[str] = None):
    """Generate from the serving plane: as a workflow op when a workflow
    is active (returns a lazy :class:`Generation` proxy), else directly.

    ``prompt``: token ids, or a proxy of them from an upstream op; a list
    of prompts fans out as ONE op node returning ``List[Generation]``.

    ``cache``: ``None`` caches exactly the greedy requests, ``True``
    forces caching, ``False`` disables it; streaming requests never
    cache (a hit skips the body: nothing would stream). ``timeout_s``,
    ``deadline_s``, the stream wiring and the workflow identity are left
    out of the key. ``stream``: a ``TokenStreamChannel`` (in-process
    runtimes only) or a channel id resolved in the process registry;
    ``stream_spill_uri``: a chunked storage mirror for a reader in
    another thread or process. The reference's ``description=`` waits
    for ``op(description=)``.
    """
    from lzy_tpu_torch.core.workflow import LzyWorkflow

    batch = _is_batch(prompt)
    if batch and (stream is not None or stream_spill_uri is not None):
        raise ValueError(
            "streaming applies to a single generation: a batch fanning "
            "into one channel would interleave rows at overlapping "
            "positions; call generate() per prompt, each with its own "
            "stream")
    params = {
        "max_new_tokens": int(max_new_tokens),
        "greedy": greedy,
        "tenant": tenant,
        "priority": priority,
    }
    opts: Dict[str, Any] = {"deadline_s": deadline_s, "timeout_s": timeout_s}
    stream_id = _register_stream(stream)
    if stream_id is not None:
        opts["stream_id"] = stream_id
        if not isinstance(stream, str):
            # the caller holds the object: the registry entry only ferries
            # the id, and the body releases it once the stream is terminal
            opts["stream_owned"] = True
    if stream_spill_uri is not None:
        opts["stream_spill_uri"] = stream_spill_uri
    step = conversation.next_step() if conversation is not None else None
    if step is not None:
        params["step"] = step
    wf = LzyWorkflow.get_active()
    body = llm_generate_batch if batch else llm_generate
    if wf is None:
        digest = model_digest or _backend_digest()
        return body(prompt, params, digest, conversation, opts)

    _check_stream_travels(wf, stream, stream_spill_uri)
    auth = wf.owner.runtime.auth_context()
    if auth.get("user") is not None:
        opts["wf_user"] = auth["user"]
    digest = model_digest or _backend_digest()
    streaming = stream_id is not None or stream_spill_uri is not None
    if cache is None:
        effective_cache = greedy is True and not streaming
    else:
        effective_cache = bool(cache) and not streaming
        if cache and streaming:
            _LOG.warning("llm.generate: caching disabled for a streaming "
                         "request (a cache hit skips the body: nothing "
                         "would stream)")
    from lzy_tpu_torch.core.call import CacheSettings, LzyCall
    from lzy_tpu_torch.core.signatures import infer_and_validate_call_signature

    signature = infer_and_validate_call_signature(
        body, prompt, params, digest, conversation, opts)
    call = LzyCall(
        workflow=wf,
        signature=signature,
        env=wf.owner.env.combine(wf.env),
        # runtime_opts cannot change the output: out of the cache key
        cache=CacheSettings(cache=effective_cache, version=cache_version,
                            exclude_args=("runtime_opts",)),
    )
    wf.register_call(call)
    return call.build_results()


def generate_batch(prompts: Sequence[Sequence[int]], **kwargs):
    """Batch form of :func:`generate`: one op node, a ``List[Generation]``
    result, rows dispatched concurrently."""
    prompts = [list(p) for p in prompts]
    if not all(_is_tokens(p) for p in prompts):
        raise ValueError("generate_batch wants a list of token-id lists")
    return generate(prompts, **kwargs)


def _is_tokens(p) -> bool:
    return isinstance(p, (list, tuple)) and \
        all(isinstance(t, int) for t in p)


def _is_batch(prompt) -> bool:
    return isinstance(prompt, (list, tuple)) and len(prompt) > 0 and \
        isinstance(prompt[0], (list, tuple))


def _register_stream(stream) -> Optional[str]:
    if stream is None:
        return None
    if isinstance(stream, str):
        return stream
    from lzy_tpu_torch.channels.token_stream import STREAMS

    return STREAMS.register(stream)


def _check_stream_travels(wf, stream, spill_uri) -> None:
    """A live channel object cannot follow an op out of this process:
    only its id travels. On a runtime whose op bodies may leave the
    process, reject the live object (the spill is the transport there)
    and warn about a bare id without one."""
    if wf.owner.runtime.in_process() or stream is None:
        return
    if not isinstance(stream, str):
        raise ValueError(
            "a live TokenStreamChannel cannot follow an op to another "
            "process: pass stream_spill_uri= and read it back with "
            "channels.token_stream.StorageTokenStreamReader")
    if spill_uri is None:
        _LOG.warning(
            "llm.generate: stream id %r on a remote runtime has no "
            "consumer here; add stream_spill_uri= for a reader", stream)


def _backend_digest() -> str:
    from lzy_tpu_torch.llm.backend import LlmBackendError, resolve_backend

    try:
        return resolve_backend().model_digest()
    except LlmBackendError:
        _LOG.warning("llm.generate: no backend reachable at registration; "
                     "model digest unknown (pass model_digest= for a "
                     "stable cache key)")
        return "unknown"
