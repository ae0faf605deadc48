"""The port's llm-op surface (``lzy_tpu_torch.llm``: ``llm.generate`` as a
cached op, the workflow scheduler, generation whiteboards;
``channels/token_stream.py``; the cache hooks in ``core``, the runtimes,
``snapshot`` and the remote path) held to the reference's
(``lzy_tpu.llm``), in ONE test item that collects every failure and
reports them together:

- ``RUNS``: a three-step ``generate -> tool op -> generate`` conversation
  through each package's ``llm.generate`` over a two-replica
  prefix-routed gateway, in the local runtime, at a tiny Llama (2
  layers, f32, CPU) from the same numpy-seeded weights carried across by
  ``models/convert``. Each step's tokens agree under the top-2 rule
  (``GAP_TOL``) and equal the package's own ``generate()`` oracle; each
  side's steps 2 and 3 stay on step 1's replica, routed ``fused`` or
  ``session``.
- ``CASES``: the surface's semantics case by case, following
  ``tests/test_llm_op.py`` and ``tests/test_wfsched.py``; each case runs
  on both packages and must observe the same thing: token-stream
  publish, gap and divergence, iteration, failure and the storage spill;
  a direct call outside a workflow over a bare engine (``EngineBackend``,
  a replica's), streamed and batched; a cached re-run skipping the fleet, a changed ``timeout_s`` still
  hitting, sampled requests opting out, a cancelled generation never
  poisoning the cache, the model digest keying it; in-flight dedup
  (identical greedy calls collapse, another tenant, sampled and
  streaming calls never do, a failed or cancelled leader does not fail
  its followers, a follower's timeout falls back to its own dispatch,
  duplicate batch rows reach the fleet once); a mid-stream replica
  death resuming the stream byte-identically; a fixed-seed
  ``llm.dispatch`` fault survived through each side's own ``CHAOS`` and
  exhausted retries failing the op; the generation whiteboard; and the
  chain through each side's ``InProcessCluster``, where the tool op fed
  by a finished generation is launched before an unrelated ready op and
  the cached re-run is dropped server-side.

Rules: torch runs on one thread; no socket, no subprocess, no wall-clock
assertion (waits are bounded, never timed). Every cluster gets its own
``tmp_path`` SQLite file and ``mem://`` bucket. Afterwards both sides'
``llm.configure(None)`` has run (it also resets the workflow scheduler),
the token-stream registries hold what they held, no ``CHAOS`` plan is
armed, the reference's metric and fault-point registries are unchanged,
and the live threads are back to their set from before each gateway or
cluster (the port's at once, the reference's after a bounded join).

One item only: ``--dist loadfile`` queues files by their item count, and
a one-item file queues after every seed file.
"""

import contextlib
import dataclasses
import os
import sys
import threading
import time
import types
import uuid

import numpy as np
import pytest
import torch

import lzy_tpu
import lzy_tpu_torch
from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.llama import LlamaConfig, init_params
from lzy_tpu_torch.storage.mem import MemStorageClient as PortMem

torch.set_num_threads(1)

VOCAB = 64
PAGE = 4
N_NEW = 5
#: test_torch_generate.py's greedy rule: a divergence only where the
#: reference's top-2 logit gap is below this (f32)
GAP_TOL = 1e-3
#: bounded waits for asynchronous events (threads, teardown)
SETTLE_S = 30.0
P1 = [int(x) for x in np.random.default_rng(5).integers(0, VOCAB, 17)]

# Module-level ops: cluster workers run in this interpreter and resolve
# ops by module reference, so these are the very objects the bodies see.
RAN = []


@lzy_tpu.op(cache=True, version="1")
def ref_tool(g, extra: list) -> list:
    RAN.append(("reference", "tool"))
    return g.full_tokens() + list(extra)


@lzy_tpu_torch.op(cache=True, version="1")
def port_tool(g, extra: list) -> list:
    RAN.append(("port", "tool"))
    return g.full_tokens() + list(extra)


@lzy_tpu.op
def ref_unrelated(x: int) -> int:
    RAN.append(("reference", "unrelated"))
    return x + 1


@lzy_tpu_torch.op
def port_unrelated(x: int) -> int:
    RAN.append(("port", "unrelated"))
    return x + 1


@pytest.fixture(autouse=True)
def _process_state_unchanged(monkeypatch):
    """No case may change process-wide state that a test sharing this
    worker would read."""
    import jax

    from lzy_tpu.chaos.faults import CHAOS as REF_CHAOS
    from lzy_tpu.channels.token_stream import STREAMS as REF_STREAMS
    from lzy_tpu.core.workflow import LzyWorkflow as RefWorkflow
    from lzy_tpu.durable import InjectedFailures as RefFailures
    from lzy_tpu.utils.metrics import REGISTRY as REF_REGISTRY
    from lzy_tpu_torch.chaos.faults import CHAOS
    from lzy_tpu_torch.channels.token_stream import STREAMS
    from lzy_tpu_torch.core.workflow import LzyWorkflow
    from lzy_tpu_torch.durable import InjectedFailures

    def snap():
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        return (jax.config.jax_enable_x64, env, torch.get_default_dtype(),
                torch.is_grad_enabled(), RefWorkflow.get_active(),
                LzyWorkflow.get_active(), sorted(REF_REGISTRY._metrics),
                REF_CHAOS.points(), REF_CHAOS.armed, CHAOS.armed,
                dict(REF_STREAMS._channels), dict(STREAMS._channels))

    jax.devices()
    import lzy_tpu.ops  # noqa: F401
    _packages_imported()
    # both packages' task log routers wrap the streams they find
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    before = snap()
    yield
    lzy_tpu.llm.configure(None)
    lzy_tpu_torch.llm.configure(None)
    REF_CHAOS.disarm()
    CHAOS.disarm()
    RefFailures.clear()
    InjectedFailures.clear()
    PortMem.clear_all()
    assert snap() == before


# -- the two packages ---------------------------------------------------------


def _port_cfg():
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32,
                               param_dtype=torch.float32)


def _ref_cfg():
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama

    return dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)


def _init_tree():
    """Reference-layout weights from a numpy seed."""
    cfg = _port_cfg()
    shapes = convert.to_reference(init_params(cfg, device="cpu").state_dict(),
                                  cfg)
    rng = np.random.default_rng(7)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if path.endswith("scale"):
            return np.ones_like(tree)
        std = 0.02 if path == "embed_tokens" else 1.0 / np.sqrt(tree.shape[0])
        return (rng.standard_normal(tree.shape) * std).astype(np.float32)

    return walk(shapes)


def _packages_imported():
    """Import the reference modules the cases reach before the registries
    are compared: importing one registers its metrics and fault points,
    which is the reference's doing, not the port's (its llm metrics, its
    storage transfer and its p2p channel are imported on first use)."""
    import lzy_tpu.channels.p2p  # noqa: F401
    import lzy_tpu.gateway  # noqa: F401
    import lzy_tpu.llm.metrics  # noqa: F401
    import lzy_tpu.service  # noqa: F401
    import lzy_tpu.serving  # noqa: F401
    import lzy_tpu.storage.transfer  # noqa: F401


def _packages(tree):
    """Both packages' llm surfaces, gateways and SDKs behind one
    namespace each, serving the same weights."""
    import jax
    import jax.numpy as jnp

    import lzy_tpu_torch.llm.op as port_op
    from lzy_tpu import gateway as ref_gw
    from lzy_tpu.chaos import faults as ref_faults
    from lzy_tpu.channels import token_stream as ref_ts
    from lzy_tpu.core import workflow as ref_wf
    from lzy_tpu.llm import metrics as ref_metrics
    from lzy_tpu.llm import op as ref_op
    from lzy_tpu.llm import sched as ref_sched
    from lzy_tpu.models.generate import generate as ref_generate
    from lzy_tpu.service import InProcessCluster as RefCluster
    from lzy_tpu.serving import PagedInferenceEngine as RefEngine
    from lzy_tpu.storage import DefaultStorageRegistry as RefReg
    from lzy_tpu.storage import StorageConfig as RefConfig
    from lzy_tpu.storage.registry import client_for as ref_client_for
    from lzy_tpu_torch import gateway as port_gw
    from lzy_tpu_torch.chaos import faults as port_faults
    from lzy_tpu_torch.channels import token_stream as port_ts
    from lzy_tpu_torch.core import workflow as port_wf
    from lzy_tpu_torch.llm import metrics as port_metrics
    from lzy_tpu_torch.llm import sched as port_sched
    from lzy_tpu_torch.models.generate import generate as port_generate
    from lzy_tpu_torch.service import InProcessCluster
    from lzy_tpu_torch.serving.engine import PagedInferenceEngine
    from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig
    from lzy_tpu_torch.storage.registry import client_for

    rcfg = _ref_cfg()
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.load_reference(init_params(_port_cfg(), device="cpu"),
                                   tree)

    def ref_oracle(prompt, n):
        out = ref_generate(rcfg, rparams, jnp.asarray([prompt], jnp.int32),
                           max_new_tokens=n)
        return np.asarray(out)[0, len(prompt):].tolist()

    def oracle_of(m, prompt, n):
        return port_generate(m, torch.tensor([prompt]),
                             max_new_tokens=n)[0, len(prompt):].tolist()

    def port_oracle(prompt, n):
        return oracle_of(model, prompt, n)

    ref = types.SimpleNamespace(
        name="reference", llm=lzy_tpu.llm, op_mod=ref_op, Lzy=lzy_tpu.Lzy,
        tool=ref_tool, unrelated=ref_unrelated, ts=ref_ts, sched=ref_sched,
        metrics=ref_metrics, faults=ref_faults,
        RemoteCallError=ref_wf.RemoteCallError, Registry=RefReg,
        Config=RefConfig, client_for=ref_client_for, Cluster=RefCluster,
        cluster_kw=dict(container_runtime=None), gw=ref_gw,
        gateway_kw={}, oracle=ref_oracle,
        engine=lambda **kw: RefEngine(rcfg, rparams, page_size=PAGE, **kw))
    port = types.SimpleNamespace(
        name="port", llm=lzy_tpu_torch.llm, op_mod=port_op,
        Lzy=lzy_tpu_torch.Lzy, tool=port_tool, unrelated=port_unrelated,
        ts=port_ts, sched=port_sched, metrics=port_metrics,
        faults=port_faults, RemoteCallError=port_wf.RemoteCallError,
        Registry=DefaultStorageRegistry, Config=StorageConfig,
        client_for=client_for, Cluster=InProcessCluster, cluster_kw={},
        gw=port_gw, gateway_kw=dict(page_size=PAGE), oracle=port_oracle,
        oracle_of=oracle_of,
        engine=lambda **kw: PagedInferenceEngine(model, page_size=PAGE,
                                                 **kw))
    return ref, port


def _lzy(ns, uri):
    reg = ns.Registry()
    reg.register_storage("default", ns.Config(uri=uri), default=True)
    return ns.Lzy(storage_registry=reg)


def _bucket(ns):
    return f"mem://llm-{ns.name}-{uuid.uuid4().hex}"


def _total(counter):
    return sum(counter._values.values())


def _threads_left(before, join):
    """Threads alive now that were not before; ``join`` gives stopping
    threads a bounded join first."""
    if join:
        deadline = time.monotonic() + SETTLE_S
        for t in set(threading.enumerate()) - before:
            t.join(max(0.0, deadline - time.monotonic()))
    return sorted(t.name for t in set(threading.enumerate()) - before)


def _wait_until(predicate, what):
    """Poll ``predicate`` until true: a bounded wait, not an assertion on
    how long it took."""
    deadline = time.monotonic() + SETTLE_S
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} did not happen in {SETTLE_S} s")
        time.sleep(0.002)


@contextlib.contextmanager
def _gateway(ns, fails, label, replicas=2, **engine_kw):
    """A gateway of ``replicas`` paged engines (2 slots) configured as the
    llm backend; afterwards the backend is cleared, the gateway closed and
    no thread it started may be alive."""
    before = set(threading.enumerate())
    engine_kw.setdefault("slots", 2)
    fleet = ns.gw.ReplicaFleet(lambda: ns.engine(**engine_kw))
    gw = ns.gw.GatewayService(fleet, router=ns.gw.PrefixAffinityRouter(PAGE),
                              model_name="tiny", **ns.gateway_kw)
    try:
        for _ in range(replicas):
            fleet.add_replica()
        ns.llm.configure(gw)
        yield gw
    finally:
        ns.llm.configure(None)
        gw.close()
        left = _threads_left(before, join=ns.name == "reference")
        if left:
            fails.append(f"{label}: {ns.name} left threads {left}")


# -- RUNS: the three-step conversation ----------------------------------------


def _chain(ns, fails):
    """generate -> tool -> generate -> tool -> generate in the local
    runtime: each step's (prompt, tokens, replica, routed_by)."""
    with _gateway(ns, fails, "runs"):
        conv = ns.llm.Conversation("chain")
        with _lzy(ns, _bucket(ns)).workflow("agent"):
            g1 = ns.llm.generate(P1, max_new_tokens=N_NEW, greedy=True,
                                 conversation=conv)
            g2 = ns.llm.generate(ns.tool(g1, [41, 42]), max_new_tokens=N_NEW,
                                 greedy=True, conversation=conv)
            g3 = ns.llm.generate(ns.tool(g2, [43]), max_new_tokens=N_NEW,
                                 greedy=True, conversation=conv)
            return [(list(g.prompt), list(g.tokens), g.replica, g.routed_by)
                    for g in (g1, g2, g3)]


def _ref_logits(tree, seq):
    import jax.numpy as jnp

    from lzy_tpu.models.llama import Llama as RefLlama

    return np.asarray(RefLlama(_ref_cfg()).apply(
        {"params": tree}, jnp.asarray([seq], jnp.int32)))[0]


def _runs(ref, port, tree):
    fails = []
    steps = {ns.name: _chain(ns, fails) for ns in (ref, port)}
    for ns in (ref, port):
        mine = steps[ns.name]
        for i, (prompt, tokens, _, _) in enumerate(mine):
            if tokens != ns.oracle(prompt, N_NEW):
                fails.append(f"runs: {ns.name} step {i + 1} differs from "
                             f"its own generate()")
        replicas = {r for _, _, r, _ in mine}
        if len(replicas) != 1 or any(why not in ("fused", "session")
                                     for _, _, _, why in mine[1:]):
            fails.append(f"runs: {ns.name} steps left the pinned replica: "
                         f"{[(r, why) for _, _, r, why in mine]}")
    for i, ((rp, rt, _, _), (pp, pt, _, _)) in enumerate(
            zip(steps["reference"], steps["port"])):
        if rp != pp:
            fails.append(f"runs: step {i + 1} prompts differ")
            break
        if rt != pt:
            logits = _ref_logits(tree, rp + rt)
            k = next(j for j, (a, b) in enumerate(zip(rt, pt)) if a != b)
            top2 = np.sort(logits[len(rp) - 1 + k])[-2:]
            if float(top2[1] - top2[0]) >= GAP_TOL:
                fails.append(f"runs: step {i + 1} diverges at token {k} "
                             f"where the reference's top-2 gap is "
                             f"{float(top2[1] - top2[0])}")
            break
    return fails


# -- CASES --------------------------------------------------------------------


def _raised(fn):
    try:
        fn()
        return "returned"
    except Exception as e:  # noqa: BLE001 — the observation under test
        return type(e).__name__


def case_token_stream(ns, fails, tmp_path):
    ts = ns.ts
    out = {}
    ch = ts.TokenStreamChannel()
    ch.publish(0, [1, 2, 3])
    ch.publish(0, [1, 2, 3, 4])
    ch.publish(4, [5])
    ch.publish(2, [3, 4, 5])
    out["publish"] = ch.tokens()
    out["gap"] = _raised(lambda: ch.publish(7, [9]))
    out["divergence"] = _raised(lambda: ch.publish(0, [1, 9]))
    out["after_errors"] = ch.tokens()
    out["read"] = ch.read(1)
    ch.ack(3)
    out["acked"] = ch.acked
    got = []
    it = ts.TokenStreamChannel()
    consumer = threading.Thread(target=lambda: got.extend(it))
    consumer.start()
    for i in range(5):
        it.publish(i, [i * 10])
    it.close("ok")
    consumer.join(SETTLE_S)
    out["iterated"] = (got, it.status, it.read(5))
    failed = ts.TokenStreamChannel()
    failed.publish(0, [1])
    failed.fail("replica on fire")
    out["failed"] = (_raised(lambda: list(failed)),
                     _raised(lambda: failed.read(1, timeout_s=1)))
    out["closed_publish"] = (_raised(lambda: it.publish(0, [0, 10])),
                             _raised(lambda: it.publish(5, [1])))
    uri = _bucket(ns)
    client = ns.client_for(ns.Config(uri=uri))
    w = ts.StorageTokenStreamWriter(client, f"{uri}/s1", chunk_tokens=4)
    w.append([1, 2, 3, 4, 5])
    w.append([6])
    w.finish("ok")
    doc = ts.StorageTokenStreamReader(client, f"{uri}/s1").read_all(5)
    out["spill"] = (doc, list(ts.StorageTokenStreamReader(
        client, f"{uri}/s1").iter_tokens(5)))
    w = ts.StorageTokenStreamWriter(client, f"{uri}/s2")
    w.append([7])
    w.finish("error", error="boom")
    out["spill_failed"] = _raised(lambda: ts.StorageTokenStreamReader(
        client, f"{uri}/s2").read_all(5))

    class Stalled:
        def join(self, timeout=None):
            pass

        def is_alive(self):
            return True

    src = ts.TokenStreamChannel()
    src.publish(0, [1, 2, 3])
    src.close("ok")
    w = ts.StorageTokenStreamWriter(client, f"{uri}/s3")
    w.append([1])
    ns.op_mod._finish_spill(src, w, Stalled())
    try:
        ts.StorageTokenStreamReader(client, f"{uri}/s3").read_all(5)
        out["stalled"] = "returned"
    except ts.StreamFailed as e:
        out["stalled"] = "stalled" in str(e)
    reg = ts.TokenStreamRegistry()
    a = reg.get_or_create("t1")
    out["registry"] = (reg.get_or_create("t1") is a, reg.get("t1") is a)
    reg.release("t1")
    out["released"] = reg.get("t1") is None
    return out


class _CountingPlane:
    """A serving plane that counts calls and replies from ``replies``."""

    def __init__(self, replies):
        self.calls = 0
        self._replies = replies

    def generate(self, prompt, *, max_new_tokens=64, timeout_s=None,
                 deadline_s=None, greedy=None, tenant=None, priority=None,
                 session=None):
        self.calls += 1
        return self._replies(self.calls)


def _direct(ns, engine):
    """Outside a workflow ``llm.generate`` just runs: over a bare engine
    (``EngineBackend``), streamed, and as a batch."""
    ns.llm.configure(ns.llm.EngineBackend(engine, model_name="tiny"))
    ch = ns.ts.TokenStreamChannel()
    g = ns.llm.generate([7, 2, 8, 1], max_new_tokens=6, greedy=True,
                        stream=ch)
    oracle = ns.oracle([7, 2, 8, 1], 6)
    batch = ns.llm.generate_batch([[5, 9, 3], [7, 2, 8, 1]],
                                  max_new_tokens=4, greedy=True)
    return dict(kind=type(g).__name__, tokens=g.tokens == oracle,
                stream=(ch.tokens() == oracle, ch.status),
                full=g.full_tokens() == [7, 2, 8, 1] + oracle, model=g.model,
                batch=[b.tokens == ns.oracle(p, 4) for b, p in
                       zip(batch, ([5, 9, 3], [7, 2, 8, 1]))])


def case_cache(ns, fails, tmp_path):
    out = {}
    hits = ns.metrics.CACHED_HITS
    with _gateway(ns, fails, "cache", replicas=1) as gw:
        uri = _bucket(ns)
        runs = []
        for timeout_s in (None, None, 77.0):
            h0 = _total(hits)
            with _lzy(ns, uri).workflow("cached"):
                g = ns.llm.generate([5, 9, 3, 1, 2, 6, 7, 4], max_new_tokens=4,
                                    greedy=True, timeout_s=timeout_s)
                tokens = list(g.tokens)
            runs.append((tokens, gw.stats()["requests_finished"],
                         _total(hits) - h0))
        out["cached_reruns"] = runs
        # the digest is an op input: another digest misses
        ns.llm.configure(ns.llm.ServiceBackend(gw, digest="model-B"))
        with _lzy(ns, uri).workflow("cached"):
            ns.llm.generate([5, 9, 3, 1, 2, 6, 7, 4], max_new_tokens=4,
                            greedy=True).tokens
        out["other_digest"] = gw.stats()["requests_finished"]
        out["direct"] = _direct(ns, gw.fleet.replicas()[0].engine)
    with _gateway(ns, fails, "cache", replicas=1, temperature=0.8,
                  seed=3) as gw:
        uri = _bucket(ns)
        for _ in range(2):
            with _lzy(ns, uri).workflow("sampled"):
                ns.llm.generate([5, 9, 3, 1, 2, 6, 7, 4], max_new_tokens=3)
        out["sampled"] = gw.stats()["requests_finished"]
    plane = _CountingPlane(lambda n: (
        {"tokens": [1], "status": "cancelled"} if n == 1
        else {"tokens": [1, 2, 3, 4], "status": "ok"}))
    ns.llm.configure(ns.llm.ServiceBackend(plane, digest="d"))
    uri = _bucket(ns)
    seen = []
    for deadline_s in (0.001, 60.0, 60.0):
        with _lzy(ns, uri).workflow("doomed"):
            g = ns.llm.generate([3, 1, 4], max_new_tokens=4, greedy=True,
                                deadline_s=deadline_s)
            seen.append((g.status, list(g.tokens), plane.calls))
    out["cancelled"] = seen
    ns.llm.configure(None)
    return out


class _GatedPlane:
    """Every generate blocks on ``gate`` and is counted."""

    def __init__(self, replies=None):
        self.calls = 0
        self.gate = threading.Event()
        self._lock = threading.Lock()
        self._replies = replies

    def model_digest(self):
        return "fake-digest"

    def generate(self, prompt, **kw):
        with self._lock:
            self.calls += 1
            n = self.calls
        if not self.gate.wait(SETTLE_S):
            raise TimeoutError("test gate never opened")
        if self._replies is not None:
            return self._replies(n)
        return {"tokens": [100 + n], "status": "ok"}


def _dispatch_into(sched, results, i, prompt, **kw):
    def run():
        try:
            results[i] = sched.dispatch(prompt, **kw)
        except BaseException as e:  # noqa: BLE001 — the observation
            results[i] = type(e).__name__

    t = threading.Thread(target=run)
    t.start()
    return t


def _dedup_round(ns, plane, calls, first, second=(), follower_kw=None):
    """``first`` dispatches in flight, then ``second`` ones (each waits
    until the previous is parked), then the gate opens. Returns the
    results, the plane's calls and the scheduler's stats."""
    # the plane has no park surface, so fusion never applies: the
    # reference's defaults (dedup and fusion on) are the port's
    sched = ns.sched.WorkflowScheduler(plane)
    try:
        results, threads = {}, []
        for i, kw in enumerate(first):
            threads.append(_dispatch_into(sched, results, i, [1, 2, 3],
                                          max_new_tokens=4, **kw))
        _wait_until(lambda: calls() == len(first), "leaders in flight")
        for j, kw in enumerate(second):
            i = len(first) + j
            threads.append(_dispatch_into(sched, results, i, [1, 2, 3],
                                          max_new_tokens=4, **kw))
            if follower_kw == "park":
                _wait_until(lambda: sched.stats()["dedup_waiting"] == j + 1,
                            "followers parked")
            else:
                _wait_until(lambda: calls() == i + 1, "calls in flight")
        return sched, results, threads
    except BaseException:
        sched.close()
        raise


def case_dedup(ns, fails, tmp_path):
    out = {}
    # identical greedy calls collapse; followers get their own lists
    plane = _GatedPlane()
    sched, res, threads = _dedup_round(
        ns, plane, lambda: plane.calls, [dict(greedy=True)],
        [dict(greedy=True)] * 3, follower_kw="park")
    plane.gate.set()
    for t in threads:
        t.join(SETTLE_S)
    lists = [res[i]["tokens"] for i in range(4)]
    out["collapse"] = (plane.calls, [res[i] for i in range(4)],
                       len({id(x) for x in lists}),
                       {k: v for k, v in sched.stats().items()})
    sched.close()
    # another tenant, sampled and streaming calls never dedup
    for label, kw in (("tenant", [dict(greedy=True, tenant="a"),
                                  dict(greedy=True, tenant="b")]),
                      ("sampled_none", [dict(greedy=None)] * 2),
                      ("sampled_false", [dict(greedy=False)] * 2),
                      ("stream", [dict(greedy=True, stream=object())] * 2)):
        plane = _GatedPlane()
        sched, res, threads = _dedup_round(ns, plane, lambda: plane.calls,
                                           kw[:1], kw[1:])
        plane.gate.set()
        for t in threads:
            t.join(SETTLE_S)
        out[label] = (plane.calls, sched.stats()["dedup_hits"])
        sched.close()
    # a cancelled leader is its own outcome: the follower re-dispatches
    plane = _GatedPlane(replies=lambda n: (
        {"tokens": [1], "status": "cancelled"} if n == 1
        else {"tokens": [7, 8], "status": "ok"}))
    sched, res, threads = _dedup_round(
        ns, plane, lambda: plane.calls, [dict(greedy=True)],
        [dict(greedy=True)], follower_kw="park")
    plane.gate.set()
    for t in threads:
        t.join(SETTLE_S)
    out["cancelled_leader"] = (res, plane.calls, sched.stats()["dedup_hits"])
    sched.close()
    # a failed leader fails only its own caller
    gate, calls = threading.Event(), {"n": 0}

    class RaiseThenOk:
        def model_digest(self):
            return "d"

        def generate(self, prompt, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                gate.wait(SETTLE_S)
                raise RuntimeError("leader replica on fire")
            return {"tokens": [9], "status": "ok"}

    sched, res, threads = _dedup_round(
        ns, RaiseThenOk(), lambda: calls["n"], [dict(greedy=True)],
        [dict(greedy=True)], follower_kw="park")
    gate.set()
    for t in threads:
        t.join(SETTLE_S)
    out["failed_leader"] = (res, calls["n"])
    sched.close()
    # a follower whose leader outlives its timeout dispatches for itself
    gate, calls = threading.Event(), {"n": 0}

    class SlowLeader:
        def model_digest(self):
            return "d"

        def generate(self, prompt, **kw):
            calls["n"] += 1
            n = calls["n"]
            if n == 1:
                gate.wait(SETTLE_S)
            return {"tokens": [n], "status": "ok"}

    sched = ns.sched.WorkflowScheduler(SlowLeader())
    res = {}
    t1 = _dispatch_into(sched, res, 0, [4, 4], max_new_tokens=2, greedy=True)
    _wait_until(lambda: calls["n"] == 1, "leader in flight")
    t2 = _dispatch_into(sched, res, 1, [4, 4], max_new_tokens=2, greedy=True,
                        timeout_s=0.05)
    t2.join(SETTLE_S)
    follower = (dict(res), calls["n"], sched.stats()["dedup_hits"])
    gate.set()
    t1.join(SETTLE_S)
    out["follower_timeout"] = (follower, res[0])
    sched.close()
    # duplicate batch rows reach the fleet once each
    with _gateway(ns, fails, "dedup") as gw:
        pa, pb = [5, 9, 3, 1], [7, 2, 8, 1, 4]
        d0 = _total(ns.metrics.DEDUP_HITS)
        with _lzy(ns, _bucket(ns)).workflow("fanin"):
            outs = ns.llm.generate_batch([pa, pa, pb, pa], max_new_tokens=4,
                                         greedy=True)
            rows = [list(g.tokens) for g in outs]
            aliased = outs[0].tokens is outs[1].tokens
        out["batch"] = (gw.stats()["requests_finished"],
                        _total(ns.metrics.DEDUP_HITS) - d0,
                        rows == [ns.oracle(p, 4) for p in (pa, pa, pb, pa)],
                        aliased)
    return out


def case_failover(ns, fails, tmp_path):
    """The serving replica's loop dies once the request has 3 tokens: the
    gateway fences them, the retry re-attaches the stream at the fence."""
    with _gateway(ns, fails, "failover", replicas=3) as gw:
        fired = []
        for replica in gw.fleet.replicas():
            engine, step = replica.engine, replica.engine.step

            def armed(engine=engine, step=step):
                live = [r for r in engine._active if r is not None]
                if not fired and live and len(live[0].tokens) >= 3:
                    fired.append(engine)
                    raise RuntimeError("replica host on fire")
                return step()

            engine.step = armed
        ch = ns.ts.TokenStreamChannel()
        with _lzy(ns, _bucket(ns)).workflow("streamed-kill"):
            g = ns.llm.generate([7, 2, 8, 1], max_new_tokens=24, greedy=True,
                                stream=ch, timeout_s=120)
            tokens, failovers = list(g.tokens), g.failovers
        oracle = ns.oracle([7, 2, 8, 1], 24)
        return dict(fired=len(fired), tokens=tokens == oracle,
                    failovers=failovers, stream=ch.tokens() == oracle,
                    resumptions=ch.resumptions, status=ch.status,
                    released=ns.ts.STREAMS.get(ch.id) is None)


def case_chaos(ns, fails, tmp_path):
    faults = ns.faults
    out = {}
    with _gateway(ns, fails, "chaos") as gw:
        r0 = _total(ns.metrics.DISPATCH_RETRIES)
        faults.CHAOS.arm(faults.FaultPlan(
            11, rate=1.0, modes=(faults.ERROR,), points=("llm.dispatch",),
            max_faults=1))
        try:
            with _lzy(ns, _bucket(ns)).workflow("chaotic"):
                g = ns.llm.generate([7, 2, 8, 1], max_new_tokens=5,
                                    greedy=True)
                tokens = list(g.tokens)
        finally:
            plan = faults.CHAOS.disarm()
        out["survived"] = (plan.fired, tokens == ns.oracle([7, 2, 8, 1], 5),
                           _total(ns.metrics.DISPATCH_RETRIES) - r0)
        finished = gw.stats()["requests_finished"]
        faults.CHAOS.arm(faults.FaultPlan(
            11, rate=1.0, modes=(faults.ERROR,), points=("llm.dispatch",)))
        try:
            with _lzy(ns, _bucket(ns)).workflow("doomed"):
                ns.llm.generate([7, 2, 8, 1], max_new_tokens=3, greedy=True)
            out["exhausted"] = "returned"
        except ns.RemoteCallError as e:
            out["exhausted"] = type(e.__cause__).__name__
        finally:
            plan = faults.CHAOS.disarm()
        out["exhausted_fired"] = (plan.fired,
                                  gw.stats()["requests_finished"] - finished)
    return out


def case_whiteboard(ns, fails, tmp_path):
    plane = _CountingPlane(lambda n: {"tokens": [4, 5, 6], "status": "ok",
                                      "replica": "r-1", "routed_by": "load"})
    ns.llm.configure(ns.llm.ServiceBackend(plane, digest="digest-1"))
    uri = _bucket(ns)
    conv = ns.llm.Conversation("wb-conv")
    with _lzy(ns, uri).workflow("record") as wf:
        g = ns.llm.generate([1, 2, 3], max_new_tokens=3, greedy=True,
                            conversation=conv)
        wb = ns.llm.record_generation(wf, g, conversation=conv)
    found = _lzy(ns, uri).whiteboards(name=ns.llm.GENERATION_WB_NAME,
                                      tags=["conversation:wb-conv"])
    ns.llm.configure(None)
    return dict(
        ids=[w.id for w in found] == [wb.id],
        fields=[(w.prompt, w.tokens, w.model_digest, w.params,
                 {k: v for k, v in w.provenance.items()
                  if k not in ("wall_ms", "request_id")}) for w in found])


def _cluster_chain(ns, cluster):
    """g1 -> tool, with an unrelated op registered in between, then g2 on
    the tool's output (one task at a time: the launch order shows)."""
    conv = ns.llm.Conversation("remote-chain")
    with cluster.lzy().workflow("remote-agent") as wf:
        g1 = ns.llm.generate(P1, max_new_tokens=N_NEW, greedy=True,
                             conversation=conv)
        u = ns.unrelated(1)
        p2 = ns.tool(g1, [41, 42])
        g2 = ns.llm.generate(p2, max_new_tokens=N_NEW, greedy=True,
                             conversation=conv)
        del u
        steps = [(list(g.tokens), g.replica, g.routed_by) for g in (g1, g2)]
        graphs = cluster.store.kv_get("executions", wf.execution_id)["graphs"]
    return steps, len(graphs)


def case_cluster(ns, fails, tmp_path):
    before = set(threading.enumerate())
    tag = f"{ns.name}-{uuid.uuid4().hex}"
    out = {}
    with _gateway(ns, fails, "cluster") as gw:
        cluster = ns.Cluster(db_path=str(tmp_path / f"{tag}.db"),
                             storage_uri=f"mem://{tag}", **ns.cluster_kw)
        try:
            cluster.graph_executor.max_running_tasks = 1
            del RAN[:]
            steps, graphs = _cluster_chain(ns, cluster)
            out["order"] = [op for pkg, op in RAN if pkg == ns.name]
            out["graphs"] = graphs
            running = list(P1)
            oracle = []
            for i, (tokens, _, _) in enumerate(steps):
                oracle.append(tokens == ns.oracle(running, N_NEW))
                running = running + tokens + [41, 42]
            out["oracle"] = oracle
            out["pinned"] = (len({r for _, r, _ in steps}) == 1
                             and steps[1][2] in ("fused", "session"))
            out["tenant"] = "test-user" in gw.stats()["tenants"]
            h0 = _total(ns.metrics.CACHED_HITS)
            finished = gw.stats()["requests_finished"]
            del RAN[:]
            again, graphs = _cluster_chain(ns, cluster)
            out["rerun"] = (graphs, [op for pkg, op in RAN if pkg == ns.name],
                            gw.stats()["requests_finished"] - finished,
                            _total(ns.metrics.CACHED_HITS) - h0,
                            [t for t, _, _ in again]
                            == [t for t, _, _ in steps])
        finally:
            cluster.shutdown()
    left = _threads_left(before, join=ns.name == "reference")
    if left:
        fails.append(f"cluster: {ns.name} left threads {left}")
    return out


CASES = [case_token_stream, case_cache, case_dedup, case_failover, case_chaos,
         case_whiteboard, case_cluster]


def _port_only(port):
    """What the port leaves out (the RPC endpoint route, bearer tokens,
    the scheduler options nothing in the port calls) and adds (the
    gateway build function's ``temperature=``)."""
    fails = []
    os_env = os.environ.get("LZY_LLM_ENDPOINT")
    if os_env is None:
        os.environ["LZY_LLM_ENDPOINT"] = "localhost:1"
        try:
            port.llm.resolve_backend()
            fails.append("port: LZY_LLM_ENDPOINT resolved a backend")
        except port.llm.LlmBackendError as e:
            if "RpcInferenceClient" not in str(e):
                fails.append(f"port: LZY_LLM_ENDPOINT error {e}")
        finally:
            del os.environ["LZY_LLM_ENDPOINT"]
    for kw in ("dedup", "fuse", "speculate", "park_ttl_s", "max_workers"):
        try:
            port.sched.WorkflowScheduler(object(), **{kw: 1}).close()
            fails.append(f"port: WorkflowScheduler({kw}=) accepted")
        except TypeError:
            pass
    for make in (lambda: port.llm.ServiceBackend(object(), token="t"),
                 lambda: port.llm.configure(object(), token="t")):
        try:
            make()
            fails.append("port: a bearer token was accepted")
        except TypeError:
            pass
    if sorted(port.llm.__all__) != sorted(lzy_tpu.llm.__all__):
        fails.append("port: llm.__all__ differs from the reference's")
    # build_gateway_service(temperature=): a request not pinned greedy is
    # sampled as an engine of that temperature samples it
    from lzy_tpu_torch.service.inference import build_gateway_service
    from lzy_tpu_torch.serving.engine import PagedInferenceEngine

    before = set(threading.enumerate())
    gw = build_gateway_service("tiny", device="cpu", cfg=_port_cfg(),
                               replicas=1, paged=True, page_size=PAGE,
                               autoscale=False, start=False,
                               temperature=0.8)
    try:
        model = gw.fleet.replicas()[0].engine.model
        got = gw.generate(P1, max_new_tokens=N_NEW)["tokens"]
        twin = PagedInferenceEngine(model, page_size=PAGE, temperature=0.8)
        req = twin.submit(P1, max_new_tokens=N_NEW)
        while not req.done:
            twin.step()
        greedy = gw.generate(P1, max_new_tokens=N_NEW, greedy=True)
        if got != req.tokens or greedy["tokens"] != port.oracle_of(
                model, P1, N_NEW):
            fails.append(f"port: temperature= gateway sampled {got}, an "
                         f"engine of that temperature {req.tokens}")
    finally:
        gw.close()
    left = _threads_left(before, join=False)
    if left:
        fails.append(f"port: the temperature gateway left threads {left}")
    return fails


def test_llm_surface_matches_reference(tmp_path):
    tree = _init_tree()
    ref, port = _packages(tree)
    fails = _runs(ref, port, tree)
    for case in CASES:
        seen = {}
        for ns in (ref, port):
            try:
                seen[ns.name] = case(ns, fails, tmp_path)
            except Exception as e:  # noqa: BLE001 — collected, reported
                seen[ns.name] = f"raised {type(e).__name__}: {e}"
        if seen["reference"] != seen["port"]:
            fails.append(f"{case.__name__}: reference {seen['reference']!r}"
                         f" != port {seen['port']!r}")
    fails += _port_only(port)
    assert not fails, "\n".join(fails)
