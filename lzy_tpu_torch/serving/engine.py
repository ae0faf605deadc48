"""Continuous-batching inference engines over a fixed slot batch.

The port's counterpart of ``lzy_tpu/serving/engine.py``:

- :class:`InferenceEngine` — the shared round loop (reap, admit, advance
  one prefill job, one decode round) over a dense ``[slots, L, ...]``
  KV cache, requests admitted mid-flight;
- :class:`PagedInferenceEngine` — the same loop over a shared paged KV
  pool with radix prefix reuse, block-budgeted admission, decode growth
  with youngest-first preemption, and speculative verify, reading K/V
  through the page table (the hand-written CUDA kernel on the card, the
  plain version on the CPU: the pool's device decides).

Each decode round dispatches its device work and takes exactly ONE
device-to-host transfer (:meth:`InferenceEngine._fetch`, counted in
``host_fetches``): the next tokens (or the packed speculative emit
matrix, with acceptance computed on the device). Everything else the
host needs between rounds it already mirrors (``_pos``, ``_cur``, the
page tables). The KV cache is allocated once and updated in place.

Left out of this slice (see ROADMAP): the KV tiers (demotion/promotion),
parked conversation chains, cross-replica KV import/export and
disaggregated prefill/decode.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lzy_tpu_torch.chaos.faults import CHAOS, CRASH, DELAY, ERROR, SLOW
from lzy_tpu_torch.models.generate import (
    decode_config, pad_chunk, prefill_plan, sample_token)
from lzy_tpu_torch.models.llama import DenseKVCache, Llama, PagedKVPool
from lzy_tpu_torch.serving.kv_cache import (
    NoFreeBlocks, RadixCache, blocks_for, blocks_for_bytes)
from lzy_tpu_torch.serving.scheduler import (
    AdmissionError, PromptTooLong, Request, RequestQueue)
from lzy_tpu_torch.serving.spec import (
    ACCEPT_RATE as _SPEC_RATE, ACCEPTED as _SPEC_ACCEPTED,
    DRAFT_TRUNCATED as _SPEC_TRUNCATED, NgramProposer,
    PROPOSED as _SPEC_PROPOSED, TOKENS_PER_STEP as _SPEC_TPS,
    VERIFY_STEPS as _SPEC_STEPS)
from lzy_tpu_torch.serving.tenancy import (
    TENANT_KV_BLOCKS, TENANT_REQUESTS, TENANT_TOKENS, TENANT_TTFT)
from lzy_tpu_torch.utils.clock import SYSTEM_CLOCK
from lzy_tpu_torch.utils.log import get_logger
from lzy_tpu_torch.utils.metrics import REGISTRY

_LOG = get_logger(__name__)

_TTFT = REGISTRY.histogram(
    "lzy_inference_ttft_seconds",
    "submit-to-first-token latency (includes queueing and prefill)",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 60.0))
_STEP = REGISTRY.histogram(
    "lzy_inference_decode_step_seconds",
    "one decode round over the slot batch (dispatch to fence)",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0))
_TOKENS = REGISTRY.counter(
    "lzy_inference_tokens_total", "generated tokens (all requests)")
_REQUESTS = REGISTRY.counter(
    "lzy_inference_requests_total", "finished requests by outcome")
_BUSY = REGISTRY.gauge(
    "lzy_inference_slots_busy", "decode slots currently generating")
_SLOTS = REGISTRY.gauge("lzy_inference_slots", "decode slot capacity")
_TPS = REGISTRY.gauge(
    "lzy_inference_tokens_per_s",
    "instantaneous decode throughput (tokens / last round wall time)")
_PREFILL_ROUNDS = REGISTRY.counter(
    "lzy_inference_prefill_rounds_total",
    "bounded prefill rounds run between decode steps (chunked prefill)")
_ROUND_PHASE = REGISTRY.histogram(
    "lzy_engine_round_phase_seconds",
    "decode-round phase wall time (phase=plan|overlap|fence|emit)",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.02, 0.05, 0.25, 1.0))
_ROUND_FENCES = REGISTRY.counter(
    "lzy_engine_round_fences_total",
    "device-to-host fences taken by decode rounds (exactly one per round)")
_ROUNDS = REGISTRY.counter(
    "lzy_engine_rounds_total",
    "decode scheduling rounds by kind (kind=decode|verify)")
_OVERLAP_COMMITS = REGISTRY.counter(
    "lzy_engine_admission_plan_total",
    "admission plans computed in the overlap window, by outcome "
    "(outcome=committed|stale|empty)")
_DISPATCHES = REGISTRY.counter(
    "lzy_kernel_dispatch_total",
    "paged forwards by attention read path (path=cuda|plain)")

# chaos boundaries: both run inside the engine loop, whose death handler
# fails outstanding requests and closes the engine
_FP_STEP = CHAOS.register(
    "engine.step", crash_ok=True, modes=(ERROR, DELAY, SLOW, CRASH),
    doc="one engine scheduling round (loop death -> requests failed)")
_FP_PREFILL = CHAOS.register(
    "engine.prefill", crash_ok=True, modes=(ERROR, DELAY, SLOW, CRASH),
    doc="prefill device section (error: that request fails)")

_EMPTY_TENANT_ROW = {"requests_finished": 0, "tokens_generated": 0,
                     "requests_cancelled": 0, "requests_preempted": 0,
                     "requests_error": 0}


@dataclasses.dataclass
class _PrefillJob:
    """One admitted request's in-progress prefill. With a
    ``prefill_budget`` the engine advances jobs at most ``budget`` prompt
    tokens per round, interleaved with decode rounds; the chunk plan is
    fixed at staging, so pausing changes scheduling, never numerics."""

    req: Request
    slot: int                       # reserved; activates on completion
    plan: list                      # [(start, take, width)] over suffix
    next_chunk: int = 0
    done: int = 0                   # suffix tokens already prefilled
    cache: Any = None               # dense: private batch-1 cache
    last: Any = None                # logits at the last real position
    matched: int = 0                # paged: radix-matched prompt prefix
    table: list = dataclasses.field(default_factory=list)  # paged blocks
    tokens_dev: Any = None          # [1, len] suffix ids, uploaded once
    pt_dev: Any = None              # paged: [1, pages] page table


@dataclasses.dataclass
class EngineStats:
    slots: int
    busy: int
    queue_depth: int
    requests_finished: int
    tokens_generated: int
    requests_cancelled: int = 0
    kv_page_size: Optional[int] = None
    kv_blocks_total: Optional[int] = None
    kv_blocks_free: Optional[int] = None
    kv_blocks_cached: Optional[int] = None
    kv_evictions: Optional[int] = None
    prefix_hit_rate: Optional[float] = None
    prefill_tokens_saved: Optional[int] = None
    spec_tokens: Optional[int] = None
    spec_proposed_tokens: Optional[int] = None
    spec_accepted_tokens: Optional[int] = None
    spec_acceptance_rate: Optional[float] = None
    spec_verify_steps: Optional[int] = None
    spec_tokens_per_step: Optional[float] = None
    spec_draft_truncated: Optional[int] = None
    kernel_path: Optional[str] = None
    kv_quant: Optional[str] = None


def accept(prop, prop_len, greedy, nxt, pos):
    """Speculative acceptance on the device. Per row: the longest
    proposal prefix matching the model's argmax (``m``), the accepted
    tokens plus the bonus token after them for speculating rows, or the
    single position-0 pick for rows without a draft. Returns ``(packed
    [B, gamma+2], new_cur [B], new_pos [B])``: ``packed[:, :gamma+1]`` are
    the emitted tokens and ``packed[:, gamma+1]`` the per-row count — one
    array, one host transfer for the round."""
    width = prop.shape[1] + 1
    cols = torch.arange(width - 1, device=prop.device)
    ok = (prop == greedy[:, :-1]) & (cols[None, :] < prop_len[:, None])
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    spec = prop_len > 0
    bonus = greedy.gather(1, m[:, None])[:, 0]
    allc = torch.arange(width, device=prop.device)
    prop_w = F.pad(prop, (0, 1))
    emit = torch.where(allc[None, :] < m[:, None], prop_w,
                       torch.where(allc[None, :] == m[:, None],
                                   bonus[:, None], torch.zeros_like(prop_w)))
    emit[:, 0] = torch.where(spec, emit[:, 0], nxt)
    count = torch.where(spec, m + 1, torch.ones_like(m))
    new_cur = emit.gather(1, (count - 1)[:, None])[:, 0]
    packed = torch.cat([emit, count[:, None]], dim=1)
    return packed, new_cur, (pos + count).to(torch.int32)


class InferenceEngine:
    """Serve ``generate``-style requests from a shared slot batch.

    Drive it with the background loop (``start()``/``close()``) or
    synchronously with ``step()`` from one thread (the deterministic test
    mode) — not both at once. ``model`` is a port
    :class:`~lzy_tpu_torch.models.llama.Llama`; the engine runs on the
    model's device."""

    def __init__(
        self,
        model: Llama,
        *,
        slots: int = 4,
        max_queue: int = 64,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_token: Optional[int] = None,
        prefill_chunk: int = 64,
        seed: int = 0,
        spec_tokens: int = 0,
        spec_ngram: int = 3,
        proposer=None,
        prefill_budget: Optional[int] = None,
        tenants=None,
        clock=None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        self.cfg = decode_config(model.cfg)
        if spec_tokens + 1 >= self.cfg.max_seq_len:
            raise ValueError(
                f"spec_tokens ({spec_tokens}) must leave room in "
                f"max_seq_len ({self.cfg.max_seq_len})")
        self.model = model
        self.device = model.device
        self.slots = slots
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self.eos_token = eos_token
        self.prefill_chunk = prefill_chunk
        self._temperature = temperature
        self._top_k, self._top_p = top_k, top_p
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.spec_tokens = int(spec_tokens)
        self._proposer = None
        if self.spec_tokens > 0:
            self._proposer = proposer if proposer is not None else \
                NgramProposer(max_ngram=spec_ngram, gamma=self.spec_tokens)
        # per-slot incremental lookup state, built in the overlap window
        self._spec_index: List[Optional[Any]] = [None] * slots

        self._active: List[Optional[Request]] = [None] * slots
        self._cur = np.zeros((slots,), np.int64)   # last token per slot
        # host mirror of each row's cached-token count (its next position)
        self._pos = np.zeros((slots,), np.int64)
        # device copies of the round inputs: normally the previous
        # round's own outputs (nothing uploaded); None = rebuild from the
        # host mirrors (only admission forces that). Idle rows drift on
        # the device — harmless: their writes land on masked positions
        # (dense) or the scratch block (paged) and nobody reads them
        self._cur_dev: Optional[torch.Tensor] = None    # [slots] int64
        self._pos_dev: Optional[torch.Tensor] = None    # [slots] int32
        self._mask_dev: Optional[torch.Tensor] = None   # [slots] bool
        #: device->host transfers taken by decode rounds (one per round)
        self.host_fetches = 0
        #: model forwards run (decode rounds, verify rounds, prefill
        #: chunks); every forward reads attention once per layer
        self.forward_calls = 0
        self._admission_plan: Any = None
        self._round_tokens: dict = {}

        self._build_decode_path()

        self.prefill_budget = (None if prefill_budget is None
                               else int(prefill_budget))
        self._prefill_jobs: List[_PrefillJob] = []
        self._next_prefill = 0
        self.prefill_rounds = 0
        self.tenants = tenants
        self._tenant_counts: dict = {}
        self._tenant_counts_lock = threading.Lock()

        self.queue = RequestQueue(max_queue, policies=tenants,
                                  clock=self._clock)
        self._finished = 0
        self._cancelled = 0
        self._tokens_out = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_steps = 0
        self.spec_draft_truncated = 0
        self.decode_steps = 0
        self.decode_rows = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0     # wall time of decode rounds
        self._stop = threading.Event()
        self._closed = False
        self._draining = False
        self._outstanding: set = set()
        self._outstanding_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        _SLOTS.set(float(slots))
        _BUSY.set(0.0)

    # -- device paths (the paged engine overrides these) -------------------

    def _build_decode_path(self) -> None:
        """The dense engine's cache: ``[slots, L, KV, D]`` rows per layer."""
        self._cache = DenseKVCache(self.cfg, self.slots, self.device)

    def _forward(self, tokens, cache, starts, page_table=None):
        self.forward_calls += 1
        return self.model(tokens, cache=cache, starts=starts,
                          page_table=page_table)

    def _decode_step(self, cur, pos, mask):
        """One 1-token forward over every slot; returns ``(new_pos,
        next_tokens)`` without leaving the device."""
        logits = self._forward(cur[:, None], self._cache, pos,
                               self._page_table_arg())
        nxt = self._pick_next(logits[:, -1], mask)
        return pos + 1, nxt

    def _verify_step(self, cur, prop, prop_len, pos, mask):
        """Speculative verify: score ``[slots, gamma+1]`` (last token plus
        each row's padded proposal) in one forward and accept on device."""
        toks = torch.cat([cur[:, None], prop], dim=1)
        logits = self._forward(toks, self._cache, pos,
                               self._page_table_arg())
        greedy = logits.argmax(dim=-1)
        nxt = self._pick_next(logits[:, 0], mask)
        return accept(prop, prop_len, greedy, nxt, pos)

    def _page_table_arg(self):
        return None

    # -- sampling ------------------------------------------------------------

    def _pick_next(self, logits, greedy_mask):
        """Sample with the engine-wide params, then overwrite rows pinned
        greedy with argmax (a no-op for all-greedy engines)."""
        nxt = sample_token(logits, self._temperature, generator=self._gen,
                           top_k=self._top_k, top_p=self._top_p)
        return torch.where(greedy_mask, logits.argmax(dim=-1), nxt)

    def _pick_first(self, logits, req: Request) -> int:
        """First token after prefill (host-side per request)."""
        if self._row_greedy(req):
            tok = logits.argmax(dim=-1)
        else:
            tok = sample_token(logits, self._temperature, generator=self._gen,
                               top_k=self._top_k, top_p=self._top_p)
        return int(tok[0])

    def _row_greedy(self, req: Request) -> bool:
        if req.greedy is not None:
            return bool(req.greedy)
        return self._temperature <= 0.0

    def _greedy_mask(self) -> np.ndarray:
        return np.asarray([self._row_greedy(r) if r is not None else True
                           for r in self._active], bool)

    # -- request surface -----------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 64,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               greedy: Optional[bool] = None,
               tenant: str = "default",
               priority: Optional[int] = None) -> Request:
        """Admit a request (raises ``AdmissionError`` under backpressure,
        ``PromptTooLong`` if it can never fit). Wait with
        ``request.result(timeout)``."""
        if self._closed or self._draining:
            raise AdmissionError("inference engine is shut down")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) + max_new_tokens > self.cfg.max_seq_len:
            raise PromptTooLong(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.cfg.max_seq_len})")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        req = Request(prompt, max_new_tokens, request_id=request_id,
                      deadline_s=deadline_s, greedy=greedy, tenant=tenant,
                      priority=priority, clock=self._clock)
        self.queue.submit(req)
        with self._outstanding_lock:
            self._outstanding = {r for r in self._outstanding if not r.done}
            self._outstanding.add(req)
        if self._closed:
            # raced a concurrent close(): nothing will pop this queue
            req.cancel()
            if not req.done:
                req.finish(error="engine shutting down")
            raise AdmissionError("inference engine is shut down")
        return req

    # -- engine loop -----------------------------------------------------------

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling round: reap, admit (stage) at most one request,
        advance one prefill job by the budget, then one decode round over
        every active slot. False when there was nothing to do."""
        if CHAOS.armed is not None and (
                self.queue.depth() or self._prefill_jobs
                or any(r is not None for r in self._active)):
            CHAOS.hit("engine.step")
        self._reap_cancelled()
        admitted = self._admit()
        progressed = self._advance_prefill()
        stepped = self._decode()
        return admitted or progressed or stepped

    def _reap_cancelled(self) -> None:
        for req in self.queue.reap_dead():
            self._finish_cancelled(req)
        for job in list(self._prefill_jobs):
            if job.req.reapable:
                self._abort_prefill_job(job)
                self._finish_cancelled(job.req)
        for slot, req in enumerate(self._active):
            if req is not None and req.reapable:
                # free BEFORE finishing: the waiter must see the slot free
                self._free(slot)
                self._finish_cancelled(req)

    def _finish_cancelled(self, req: Request) -> None:
        _REQUESTS.inc(status="cancelled")
        TENANT_REQUESTS.inc(tenant=req.tenant, status="cancelled")
        self._tenant_count(req.tenant, "requests_cancelled")
        self._cancelled += 1
        why = "cancelled" if req.cancelled else "cancelled: deadline exceeded"
        req.finish(error=why, status="cancelled")

    def _tenant_count(self, tenant: str, key: str, n: int = 1) -> None:
        with self._tenant_counts_lock:
            d = self._tenant_counts.get(tenant)
            if d is None:
                d = self._tenant_counts[tenant] = dict(_EMPTY_TENANT_ROW)
            d[key] += n

    def _admit_verdict(self, req: Request) -> str:
        """``"admit"``, ``"wait"`` (global capacity: the queue waits) or
        ``"skip"`` (a tenant-scoped limit: that tenant steps aside)."""
        return "admit"

    def _free_slot(self) -> Optional[int]:
        reserved = {job.slot for job in self._prefill_jobs}
        for slot, req in enumerate(self._active):
            if req is None and slot not in reserved:
                return slot
        return None

    def _fail_request(self, req: Request, what: str, e: Exception) -> None:
        _LOG.warning("%s failed for %s: %s", what, req.id, e)
        _REQUESTS.inc(status="error")
        TENANT_REQUESTS.inc(tenant=req.tenant, status="error")
        self._tenant_count(req.tenant, "requests_error")
        req.finish(error=f"{type(e).__name__}: {e}")

    def _try_stage(self, slot: int, req: Request) -> bool:
        self.queue.pop_request(req)
        try:
            job = self._stage_prefill(slot, req)
        except Exception as e:  # noqa: BLE001 — request-scoped
            self._fail_request(req, "prefill staging", e)
            return False
        self._prefill_jobs.append(job)
        return True

    def _commit_admission_plan(self) -> Optional[bool]:
        """Commit the admission choice planned in the previous round's
        overlap window if the queue and the admission state did not move;
        None falls back to the full scan."""
        plan, self._admission_plan = self._admission_plan, None
        if plan is None:
            return None
        version, slot, choice = plan
        if version != self.queue.version:
            _OVERLAP_COMMITS.inc(outcome="stale")
            return None
        if choice is None:
            _OVERLAP_COMMITS.inc(outcome="empty")
            return False
        reserved = {job.slot for job in self._prefill_jobs}
        if (self._active[slot] is not None or slot in reserved
                or choice.reapable
                or self._admit_verdict(choice) != "admit"):
            _OVERLAP_COMMITS.inc(outcome="stale")
            return None
        _OVERLAP_COMMITS.inc(outcome="committed")
        return True if self._try_stage(slot, choice) else None

    def _admit(self) -> bool:
        fast = self._commit_admission_plan()
        if fast is not None:
            _BUSY.set(float(sum(r is not None for r in self._active)))
            return fast
        admitted = False
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            rescan = False
            for req in self.queue.candidates():
                if req.reapable:
                    if self.queue.pop_request(req):
                        self._finish_cancelled(req)
                    rescan = True
                    break
                verdict = self._admit_verdict(req)
                if verdict == "skip":
                    continue
                if verdict == "wait":
                    break
                if self._try_stage(slot, req):
                    admitted = True
                else:
                    rescan = True
                break
            if rescan:
                continue
            break        # at most ONE staging per round
        _BUSY.set(float(sum(r is not None for r in self._active)))
        return admitted

    # -- chunked prefill -----------------------------------------------------

    def _stage_prefill(self, slot: int, req: Request) -> _PrefillJob:
        """Dense: a private batch-1 cache (spliced into the slot's rows on
        completion, so decode rounds interleaved with the prefill — which
        write garbage at idle rows — can never touch it)."""
        plan = prefill_plan(len(req.prompt), self.prefill_chunk,
                            self.cfg.max_seq_len)
        return _PrefillJob(req=req, slot=slot, plan=plan,
                           cache=DenseKVCache(self.cfg, 1, self.device))

    def _advance_prefill(self) -> bool:
        """Advance ONE pending prefill job by at most ``prefill_budget``
        prompt tokens, rotating round-robin across jobs."""
        if not self._prefill_jobs:
            return False
        if self._next_prefill >= len(self._prefill_jobs):
            self._next_prefill = 0
        job = self._prefill_jobs[self._next_prefill]
        req = job.req
        if req.reapable:
            self._abort_prefill_job(job)
            self._finish_cancelled(req)
            return True
        try:
            CHAOS.hit("engine.prefill")
            finished = self._advance_prefill_round(job)
        except Exception as e:  # noqa: BLE001 — request-scoped: a prefill
            # writes only the job's own cache rows / blocks (torch updates
            # in place, nothing shared was donated)
            self._abort_prefill_job(job)
            self._fail_request(req, "prefill", e)
            return True
        self.prefill_rounds += 1
        _PREFILL_ROUNDS.inc()
        if finished:
            self._drop_prefill_job(job)
        else:
            self._next_prefill += 1
        return True

    def _drop_prefill_job(self, job: _PrefillJob) -> None:
        idx = self._prefill_jobs.index(job)
        del self._prefill_jobs[idx]
        if self._next_prefill > idx:
            self._next_prefill -= 1

    def _abort_prefill_job(self, job: _PrefillJob) -> None:
        """Release a job's staged resources without finishing its
        request (the paged engine returns its blocks to the pool)."""
        if job in self._prefill_jobs:
            self._drop_prefill_job(job)

    def _run_prefill_chunks(self, job: _PrefillJob, cache, base: int,
                            page_table=None) -> bool:
        """Run chunks of ``job.plan`` (suffix positions offset by
        ``base``) until the plan ends or the budget is spent; True when
        finished (``job.last`` then holds the last real logits)."""
        budget = self.prefill_budget
        spent = 0
        while job.next_chunk < len(job.plan):
            start, take, width = job.plan[job.next_chunk]
            tokens = pad_chunk(job.tokens_dev[:, start:start + take],
                               take, width)
            starts = torch.full((1,), base + start, dtype=torch.int32,
                                device=self.device)
            logits = self._forward(tokens, cache, starts, page_table)
            job.last = logits[:, take - 1]
            job.next_chunk += 1
            job.done += take
            spent += take
            if budget is not None and spent >= budget \
                    and job.next_chunk < len(job.plan):
                return False
        return True

    def _advance_prefill_round(self, job: _PrefillJob) -> bool:
        req = job.req
        if job.tokens_dev is None:
            job.tokens_dev = torch.tensor([req.prompt], dtype=torch.long,
                                          device=self.device)
        if not self._run_prefill_chunks(job, job.cache, 0):
            return False
        first = self._pick_first(job.last, req)
        for big, small in ((self._cache.k, job.cache.k),
                           (self._cache.v, job.cache.v)):
            for dst, src in zip(big, small):
                dst[job.slot].copy_(src[0])
        job.cache = None
        self._finish_prefill(job.slot, req, first)
        return True

    def _finish_prefill(self, slot: int, req: Request, first: int) -> None:
        """Record TTFT, emit the first token, then free the slot (one-token
        request) or activate it."""
        now = self._clock.now()
        req.first_token_at = now
        _TTFT.observe(now - req.submitted_at)
        TENANT_TTFT.observe(now - req.submitted_at, tenant=req.tenant)
        self._pos[slot] = len(req.prompt)
        self._emit(slot, req, first, active=False)
        if req.done:
            self._free(slot)
        else:
            self._active[slot] = req
            self._cur[slot] = first
        # admission changed the live rows: re-upload the round inputs
        self._cur_dev = None
        self._pos_dev = None
        self._mask_dev = None
        self._flush_token_accounting()

    # -- decode rounds ---------------------------------------------------------

    def _fetch(self, arr: torch.Tensor) -> list:
        """THE round fence: the one device->host transfer a decode round
        takes (counted in ``host_fetches``)."""
        self.host_fetches += 1
        _ROUND_FENCES.inc()
        return arr.tolist()

    def _device_inputs(self):
        """The round inputs on the device; rebuilt from the host mirrors
        (``torch.tensor`` copies) only after an admission."""
        if self._cur_dev is None:
            self._cur_dev = torch.tensor(self._cur, device=self.device)
        if self._pos_dev is None:
            self._pos_dev = torch.tensor(self._pos.astype(np.int32),
                                         device=self.device)
        if self._mask_dev is None:
            self._mask_dev = torch.tensor(self._greedy_mask(),
                                          device=self.device)
        return self._cur_dev, self._pos_dev, self._mask_dev

    def _overlap_window(self) -> None:
        """Host work run between the round's dispatch and its fence:
        the next round's admission plan and deferred proposer indexes."""
        self._plan_admission()
        self._drain_side_work()

    def _plan_admission(self) -> None:
        slot = self._free_slot()
        if slot is None:
            self._admission_plan = None
            return
        version = self.queue.version
        choice = None
        for req in self.queue.candidates():
            if req.reapable:
                self._admission_plan = None
                return
            verdict = self._admit_verdict(req)
            if verdict == "skip":
                continue
            if verdict == "admit":
                choice = req
            break
        self._admission_plan = (version, slot, choice)

    def _drain_side_work(self) -> None:
        index_fn = getattr(self._proposer, "index", None)
        if index_fn is None:
            return
        for slot, req in enumerate(self._active):
            if req is None or not self._row_greedy(req):
                continue
            if self._spec_index[slot] is None:
                self._spec_index[slot] = index_fn(req.prompt + req.tokens)

    def _flush_token_accounting(self) -> None:
        if not self._round_tokens:
            return
        pending, self._round_tokens = self._round_tokens, {}
        total = 0
        for tenant, n in pending.items():
            total += n
            TENANT_TOKENS.inc(n, tenant=tenant)
            self._tenant_count(tenant, "tokens_generated", n)
        _TOKENS.inc(total)

    def _decode(self) -> bool:
        if not any(r is not None for r in self._active):
            return False
        t_plan = self._clock.now()
        if not self._pre_decode():
            return False
        plan = self._spec_plan()
        if plan is not None:
            return self._decode_verify(plan, t_plan)
        t0 = self._clock.now()
        cur, pos, mask = self._device_inputs()
        self._pos_dev, self._cur_dev = self._decode_step(cur, pos, mask)
        t1 = self._clock.now()
        self._overlap_window()
        t2 = self._clock.now()
        nxt = self._fetch(self._cur_dev)       # the round's ONE fence
        t3 = self._clock.now()
        dt = t3 - t0
        _STEP.observe(dt)
        for slot, req in enumerate(self._active):
            if req is not None:
                self._pos[slot] += 1
        emitted = 0
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            self._emit(slot, req, int(nxt[slot]), active=True)
            emitted += 1
        self._note_decode_round(emitted, emitted, dt)
        _BUSY.set(float(sum(r is not None for r in self._active)))
        self._note_round_phases("decode", t0 - t_plan, t2 - t1, t3 - t2,
                                self._clock.now() - t3)
        return True

    def _spec_plan(self) -> Optional[dict]:
        """Per-slot proposals for this round, or None for a plain round
        (speculation off, no usable draft, or an active row too close to
        the cache edge for the fixed-width verify write)."""
        if self._proposer is None:
            return None
        width = self.spec_tokens + 1
        plan: dict = {}
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            if int(self._pos[slot]) + width > self.cfg.max_seq_len:
                return None
            if not self._row_greedy(req):
                continue
            remaining = req.max_new_tokens - len(req.tokens)
            if remaining <= 1:
                continue
            p = self._propose_for(slot, req)
            p = p[:min(self.spec_tokens, remaining - 1)]
            if p:
                plan[slot] = [int(t) for t in p]
        return plan or None

    def _propose_for(self, slot: int, req: Request) -> List[int]:
        hist = req.prompt + req.tokens
        index_fn = getattr(self._proposer, "index", None)
        if index_fn is None:
            return self._proposer.propose(hist)
        idx = self._spec_index[slot]
        if idx is None or len(idx) > len(hist):
            # the O(history) build is overlap-window work: this round
            # simply does not speculate for the row (output-invisible)
            self._spec_index[slot] = None
            return []
        if len(idx) < len(hist):
            idx.extend(hist[len(idx):])
        return idx.propose()

    def _decode_verify(self, plan: dict, t_plan: float) -> bool:
        """One speculative round: one verify forward over ``[slots,
        gamma+1]``, acceptance on the device, one packed transfer."""
        t0 = self._clock.now()
        gamma = self.spec_tokens
        prop = np.zeros((self.slots, gamma), np.int64)
        plen = np.zeros((self.slots,), np.int64)
        for slot, p in plan.items():
            prop[slot, :len(p)] = p
            plen[slot] = len(p)
        cur, pos, mask = self._device_inputs()
        packed, self._cur_dev, self._pos_dev = self._verify_step(
            cur, torch.tensor(prop, device=self.device),
            torch.tensor(plen, device=self.device), pos, mask)
        t1 = self._clock.now()
        self._overlap_window()
        t2 = self._clock.now()
        packed = self._fetch(packed)           # the round's ONE fence
        t3 = self._clock.now()
        dt = t3 - t0
        _STEP.observe(dt)
        emit: dict = {}
        prop_total = acc_total = 0
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            n = int(packed[slot][gamma + 1])
            emit[slot] = packed[slot][:n]
            p = plan.get(slot)
            if p is not None:
                self.spec_proposed += len(p)
                self.spec_accepted += n - 1
                prop_total += len(p)
                acc_total += n - 1
        if prop_total:
            _SPEC_PROPOSED.inc(prop_total)
        if acc_total:
            _SPEC_ACCEPTED.inc(acc_total)
        # advance positions BEFORE emitting (frees reset on top of this)
        for slot in emit:
            self._pos[slot] += len(emit[slot])
        self._post_verify_rollback()
        emitted = rows = 0
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            rows += 1
            for tok in emit[slot]:
                if req.done:
                    break
                self._emit(slot, req, int(tok), active=True)
                emitted += 1
        self.spec_steps += 1
        _SPEC_STEPS.inc()
        self._note_decode_round(emitted, rows, dt)
        _BUSY.set(float(sum(r is not None for r in self._active)))
        self._note_round_phases("verify", t0 - t_plan, t2 - t1, t3 - t2,
                                self._clock.now() - t3)
        return True

    def _note_round_phases(self, kind: str, plan_dt: float,
                           overlap_dt: float, fence_dt: float,
                           emit_dt: float) -> None:
        _ROUNDS.inc(kind=kind)
        _ROUND_PHASE.observe(plan_dt, phase="plan")
        _ROUND_PHASE.observe(overlap_dt, phase="overlap")
        _ROUND_PHASE.observe(fence_dt, phase="fence")
        _ROUND_PHASE.observe(emit_dt, phase="emit")

    def _post_verify_rollback(self) -> None:
        """Hook after the rewind; the paged engine releases growth blocks
        that became wholly rejected."""

    def _note_decode_round(self, emitted: int, rows: int, dt: float) -> None:
        self._flush_token_accounting()
        self.decode_steps += 1
        self.decode_rows += rows
        self.decode_tokens += emitted
        self.decode_seconds += dt
        _TPS.set(emitted / dt if dt > 0 else 0.0)
        if self.spec_tokens:
            if self.spec_proposed:
                _SPEC_RATE.set(self.spec_accepted / self.spec_proposed)
            _SPEC_TPS.set(self.decode_tokens / self.decode_rows)

    def _pre_decode(self) -> bool:
        """Pre-round resource work; False aborts the round."""
        return True

    def _emit(self, slot: int, req: Request, token: int, *,
              active: bool) -> None:
        """Record one token; finish and free the slot on EOS or the
        length limit."""
        req.tokens.append(token)
        self._tokens_out += 1
        self._round_tokens[req.tenant] = \
            self._round_tokens.get(req.tenant, 0) + 1
        hit_eos = self.eos_token is not None and token == self.eos_token
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self._finished += 1
            _REQUESTS.inc(status="ok")
            TENANT_REQUESTS.inc(tenant=req.tenant, status="ok")
            self._tenant_count(req.tenant, "requests_finished")
            if active:
                self._free(slot)      # free BEFORE finish (see _reap)
            req.finish()
        elif active:
            self._cur[slot] = token

    def _free(self, slot: int) -> None:
        """Host-mirror reset only; the row's device state stays stale
        until the next admission rebuilds it."""
        self._active[slot] = None
        self._cur[slot] = 0
        self._pos[slot] = 0
        self._spec_index[slot] = None

    # -- lifecycle -------------------------------------------------------------

    @torch.no_grad()
    def warmup(self) -> None:
        """Pay first-use costs before the first request: build and load
        the attention kernel, initialize the math libraries. Runs one
        decode (and, with speculation, one verify) round over the idle
        rows — writes land on idle positions (dense) or the scratch block
        (paged) — with the sampling generator's state restored after."""
        state = self._gen.get_state()
        cur = torch.zeros(self.slots, dtype=torch.long, device=self.device)
        pos = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        mask = torch.ones(self.slots, dtype=torch.bool, device=self.device)
        calls = self.forward_calls
        self._decode_step(cur, pos, mask)
        if self.spec_tokens > 0:
            prop = torch.zeros((self.slots, self.spec_tokens),
                               dtype=torch.long, device=self.device)
            self._verify_step(cur, prop, torch.zeros_like(cur), pos, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.forward_calls = calls
        self._gen.set_state(state)

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> "InferenceEngine":
        """Run the engine loop in a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            try:
                while not self._stop.is_set():
                    if not self.step():
                        self._clock.wait(self.queue.work_available,
                                         timeout=0.5)
                        self.queue.work_available.clear()
            except BaseException:  # noqa: BLE001 — engine-fatal
                _LOG.exception("inference engine loop died; failing all "
                               "outstanding requests")
                self._closed = True
                for req in self.queue.drain():
                    _REQUESTS.inc(status="error")
                    req.finish(error="engine loop died")
                for slot, req in enumerate(self._active):
                    if req is not None:
                        _REQUESTS.inc(status="error")
                        req.finish(error="engine loop died")
                        self._active[slot] = None
                for req in self._fail_untracked():
                    _REQUESTS.inc(status="error")
                    req.finish(error="engine loop died")
                _BUSY.set(0.0)

        self._thread = threading.Thread(
            target=loop, name="inference-engine", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, let in-flight requests finish, then close.
        True if everything finished inside ``timeout_s``."""
        self._draining = True
        self.queue.work_available.set()
        deadline = self._clock.now() + timeout_s
        drained = False
        while self._clock.now() < deadline:
            if self._closed:
                break
            with self._outstanding_lock:
                self._outstanding = {r for r in self._outstanding
                                     if not r.done}
                busy = bool(self._outstanding)
            if not busy:
                drained = True
                break
            self._clock.sleep(0.01)
        self.close()
        return drained

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        self._stop.set()
        self.queue.work_available.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for job in list(self._prefill_jobs):
            self._abort_prefill_job(job)
        for req in self.queue.drain():
            _REQUESTS.inc(status="shed")
            req.finish(error="engine shutting down")
        for slot, req in enumerate(self._active):
            if req is not None:
                _REQUESTS.inc(status="shed")
                req.finish(error="engine shutting down")
                self._active[slot] = None
        for req in self._fail_untracked():
            _REQUESTS.inc(status="shed")
            req.finish(error="engine shutting down")
        _BUSY.set(0.0)

    def _fail_untracked(self) -> List[Request]:
        with self._outstanding_lock:
            leftovers = [r for r in self._outstanding if not r.done]
            self._outstanding.clear()
        return leftovers

    def stats(self) -> EngineStats:
        s = EngineStats(
            slots=self.slots,
            busy=sum(r is not None for r in self._active),
            queue_depth=self.queue.depth(),
            requests_finished=self._finished,
            tokens_generated=self._tokens_out,
            requests_cancelled=self._cancelled)
        if self.spec_tokens > 0:
            rate = (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)
            tps = (self.decode_tokens / self.decode_rows
                   if self.decode_rows else 0.0)
            s = dataclasses.replace(
                s, spec_tokens=self.spec_tokens,
                spec_proposed_tokens=self.spec_proposed,
                spec_accepted_tokens=self.spec_accepted,
                spec_acceptance_rate=round(rate, 4),
                spec_verify_steps=self.spec_steps,
                spec_tokens_per_step=round(tps, 4),
                spec_draft_truncated=self.spec_draft_truncated)
        return s

    def stats_by_tenant(self) -> dict:
        """Per-tenant terminal counters plus live queue depth."""
        with self._tenant_counts_lock:
            out = {t: dict(d) for t, d in self._tenant_counts.items()}
        for tenant in self.queue.tenants():
            row = out.setdefault(tenant, dict(_EMPTY_TENANT_ROW))
            row["queue_depth"] = self.queue.depth_of(tenant)
        for row in out.values():
            row.setdefault("queue_depth", 0)
        return out


class PagedInferenceEngine(InferenceEngine):
    """Continuous batching over a paged KV pool with radix prefix reuse.

    - K/V live in ONE pool of ``page_size``-token blocks per layer shared
      by all slots; a request holds a page table and commits blocks as it
      grows, so ``kv_blocks`` can sit below ``slots * max_seq_len / page``.
    - Prompts are matched against the radix tree of cached blocks: only
      the unmatched suffix is prefilled, and full prompt blocks are
      inserted after prefill.
    - Admission is budgeted against free + evictable blocks; eviction
      removes only unreferenced cached blocks (LRU); a squeeze during
      decode growth preempts the YOUNGEST active request.
    - Attention reads the pool through the page table: the CUDA kernel
      when the model lives on the card, the plain version on the CPU
      (``kernel_path`` in the stats says which).

    Greedy output equals the ``generate()`` oracle (held by the tests)."""

    def __init__(
        self,
        model: Llama,
        *,
        slots: int = 4,
        page_size: int = 16,
        kv_blocks: Optional[int] = None,
        kv_pool_bytes: Optional[int] = None,
        kv_quant: Optional[str] = None,
        **kwargs,
    ):
        base = decode_config(model.cfg)
        if page_size < 1 or base.max_seq_len % page_size:
            raise ValueError(
                f"page_size ({page_size}) must divide max_seq_len "
                f"({base.max_seq_len})")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}; known: int8")
        self._page = page_size
        self._pages_per_seq = base.max_seq_len // page_size
        self._kv_quant = kv_quant
        self.kernel_path = "cuda" if model.device.type == "cuda" else "plain"
        if kv_pool_bytes is not None:
            if kv_blocks is not None:
                raise ValueError("pass kv_blocks or kv_pool_bytes, not both")
            kv_blocks = blocks_for_bytes(
                kv_pool_bytes, page_size=page_size,
                n_kv_heads=base.n_kv_heads, head_dim=base.head_dim,
                n_layers=base.n_layers,
                elem_bytes=torch.empty((), dtype=base.dtype).element_size(),
                kv_quant=kv_quant)
        if kv_blocks is None:
            kv_blocks = slots * self._pages_per_seq + 1
        if kv_blocks < 2:
            raise ValueError(f"kv_blocks must be >= 2, got {kv_blocks}")
        self._kv_blocks = kv_blocks
        self.kv = RadixCache(kv_blocks, page_size)
        # page tables: [slots, pages_per_seq] block ids (0 = scratch);
        # _slot_blocks mirrors each row's allocated prefix
        self._tables = np.zeros((slots, self._pages_per_seq), np.int32)
        self._pt_dev: Optional[torch.Tensor] = None   # uploaded once
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        self._admit_seq = np.zeros((slots,), np.int64)
        self._admissions = 0
        super().__init__(model, slots=slots, **kwargs)

    def _build_decode_path(self) -> None:
        self._cache = PagedKVPool(self.cfg, self._kv_blocks, self._page,
                                  kv_quant=self._kv_quant,
                                  device=self.device)

    def _forward(self, tokens, cache, starts, page_table=None):
        _DISPATCHES.inc(path=self.kernel_path)
        return super()._forward(tokens, cache, starts, page_table)

    def _page_table_arg(self):
        """Device copy of ``_tables``, re-uploaded only after a table
        write dirtied it (``torch.tensor`` copies the host buffer)."""
        if self._pt_dev is None:
            self._pt_dev = torch.tensor(self._tables, device=self.device)
        return self._pt_dev

    # -- admission / prefill -----------------------------------------------

    def submit(self, prompt: Sequence[int], **kwargs) -> Request:
        prompt = list(prompt)
        need = blocks_for(len(prompt), self._page)
        if prompt and need > self._kv_blocks - 1:
            raise PromptTooLong(
                f"prompt ({len(prompt)} tokens) needs {need} KV blocks but "
                f"the pool only has {self._kv_blocks - 1}; raise kv_blocks "
                f"or shorten the prompt")
        tenant = kwargs.get("tenant") or "default"
        quota = self._tenant_quota(tenant)
        if prompt and quota is not None and need > quota:
            raise PromptTooLong(
                f"prompt ({len(prompt)} tokens) needs {need} KV blocks but "
                f"tenant {tenant!r} is capped at {quota}")
        return super().submit(prompt, **kwargs)

    def _tenant_quota(self, tenant: str) -> Optional[int]:
        if self.tenants is None:
            return None
        return self.tenants.resolve(tenant).kv_block_quota

    def _tenant_block_usage(self, tenant: str) -> int:
        held = 0
        for slot, req in enumerate(self._active):
            if req is not None and req.tenant == tenant:
                held += len(self._slot_blocks[slot])
        for job in self._prefill_jobs:
            if job.req.tenant == tenant:
                held += len(job.table)
        return held

    def _admit_verdict(self, req: Request) -> str:
        """Tenant KV quota first (skip, do not block other tenants), then
        the global pool budget (the whole queue waits)."""
        need = blocks_for(len(req.prompt), self._page)
        quota = self._tenant_quota(req.tenant)
        if quota is not None and \
                self._tenant_block_usage(req.tenant) + need > quota:
            return "skip"
        return "admit" if self.kv.available() >= need else "wait"

    def _stage_prefill(self, slot: int, req: Request) -> _PrefillJob:
        prompt = req.prompt
        t0 = len(prompt)
        # longest cached whole-block prefix, capped at prompt[:-1] so one
        # real token remains to produce the first logits
        blocks, matched = self.kv.match(prompt[:-1])
        plan = prefill_plan(t0 - matched, self.prefill_chunk,
                            self.cfg.max_seq_len - matched)
        try:
            # blocks for the REAL positions only: a padded final chunk's
            # pad positions fall past the table and land on scratch
            owned = self.kv.allocate(blocks_for(t0, self._page) - len(blocks))
        except Exception:
            self.kv.release(blocks)
            raise
        # the slot's table row stays scratch until the job completes:
        # decode rounds interleaved with this prefill must see it idle
        return _PrefillJob(req=req, slot=slot, plan=plan, matched=matched,
                           table=blocks + owned)

    def _advance_prefill_round(self, job: _PrefillJob) -> bool:
        """One budgeted round of a paged prefill: chunks at ``matched +
        done`` through the job's own page table, written into the shared
        pool in place (only into the job's owned blocks and scratch)."""
        req = job.req
        t0 = len(req.prompt)
        if job.pt_dev is None:
            pt = np.zeros((1, self._pages_per_seq), np.int32)
            pt[0, :len(job.table)] = job.table
            job.pt_dev = torch.tensor(pt, device=self.device)
            job.tokens_dev = torch.tensor([req.prompt[job.matched:]],
                                          dtype=torch.long,
                                          device=self.device)
        if not self._run_prefill_chunks(job, self._cache, job.matched,
                                        job.pt_dev):
            return False
        first = self._pick_first(job.last, req)
        slot, table = job.slot, job.table
        n_full = t0 // self._page
        if n_full:
            self.kv.insert(req.prompt[:n_full * self._page], table[:n_full])
        self._tables[slot, :len(table)] = table
        self._tables[slot, len(table):] = 0
        self._pt_dev = None
        self._slot_blocks[slot] = list(table)
        job.table = []              # now owned by the slot
        self._admissions += 1
        self._admit_seq[slot] = self._admissions
        self._finish_prefill(slot, req, first)
        return True

    def _abort_prefill_job(self, job: _PrefillJob) -> None:
        super()._abort_prefill_job(job)
        # matched blocks fall back to cached, owned ones to the free list
        self.kv.release(job.table)
        job.table = []

    # -- decode ----------------------------------------------------------------

    def _grow_for_decode(self) -> None:
        """Give every active row a block for its next write position;
        under a squeeze evict cached blocks (allocate does) and, last,
        preempt the youngest active request."""
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            pidx = int(self._pos[slot]) // self._page
            while pidx >= len(self._slot_blocks[slot]):
                try:
                    block = self.kv.allocate(1)[0]
                except NoFreeBlocks:
                    if self._preempt_youngest() == slot:
                        break     # preempted ourselves; the slot is free
                    continue
                self._slot_blocks[slot].append(block)
                self._tables[slot, len(self._slot_blocks[slot]) - 1] = block
                self._pt_dev = None

    def _preempt_youngest(self) -> int:
        victim = max(
            (s for s, r in enumerate(self._active) if r is not None),
            key=lambda s: self._admit_seq[s])
        req = self._active[victim]
        _LOG.warning("kv block pool exhausted: preempting %s", req.id)
        _REQUESTS.inc(status="preempted")
        TENANT_REQUESTS.inc(tenant=req.tenant, status="preempted")
        self._tenant_count(req.tenant, "requests_preempted")
        self._free(victim)
        req.finish(error="preempted: kv block pool exhausted")
        return victim

    def _pre_decode(self) -> bool:
        self._grow_for_decode()
        return any(r is not None for r in self._active)

    def _spec_plan(self) -> Optional[dict]:
        """Base plan, then back every speculated position with a block
        from the FREE list only (a draft never evicts or preempts); a
        draft that cannot be covered is truncated and counted."""
        plan = super()._spec_plan()
        if not plan:
            return plan
        for slot in list(plan):
            want = len(plan[slot])
            covered = self._grow_for_spec(slot, want)
            if covered < want:
                self.spec_draft_truncated += 1
                _SPEC_TRUNCATED.inc()
            plan[slot] = plan[slot][:covered]
            if not plan[slot]:
                del plan[slot]
        return plan or None

    def _grow_for_spec(self, slot: int, want: int) -> int:
        page, pos = self._page, int(self._pos[slot])
        last = (pos + want) // page
        while len(self._slot_blocks[slot]) <= last:
            if self.kv.pool.free_count() == 0:
                break
            block = self.kv.allocate(1)[0]
            self._slot_blocks[slot].append(block)
            self._tables[slot, len(self._slot_blocks[slot]) - 1] = block
            self._pt_dev = None
        covered = len(self._slot_blocks[slot]) * page
        return min(want, max(0, covered - pos - 1))

    def _post_verify_rollback(self) -> None:
        """Return growth blocks that became wholly rejected (always
        private decode growth: the prompt's blocks sit below ``_pos``);
        the block for the next write position stays."""
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            keep = blocks_for(int(self._pos[slot]) + 1, self._page)
            blocks = self._slot_blocks[slot]
            if len(blocks) > keep:
                tail = blocks[keep:]
                del blocks[keep:]
                self._tables[slot, keep:] = 0
                self._pt_dev = None
                self.kv.release(tail)

    def _free(self, slot: int) -> None:
        super()._free(slot)
        blocks = self._slot_blocks[slot]
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0
        self._pt_dev = None
        self._admit_seq[slot] = 0
        self.kv.release(blocks)

    def stats(self) -> EngineStats:
        s = super().stats()
        ks = self.kv.stats()
        return dataclasses.replace(
            s, kv_page_size=self._page, kv_blocks_total=ks.blocks_total,
            kv_blocks_free=ks.blocks_free, kv_blocks_cached=ks.blocks_cached,
            kv_evictions=ks.evictions,
            prefix_hit_rate=round(ks.hit_rate, 4),
            prefill_tokens_saved=ks.prefill_tokens_saved,
            kernel_path=self.kernel_path, kv_quant=self._kv_quant)

    def stats_by_tenant(self) -> dict:
        out = super().stats_by_tenant()
        tenants = set(out)
        tenants.update(r.tenant for r in self._active if r is not None)
        tenants.update(j.req.tenant for j in self._prefill_jobs)
        for tenant in tenants:
            held = self._tenant_block_usage(tenant)
            row = out.setdefault(tenant, dict(_EMPTY_TENANT_ROW,
                                              queue_depth=0))
            row["kv_blocks"] = held
            TENANT_KV_BLOCKS.set(float(held), tenant=tenant)
        return out
