"""The port's in-process cluster (``lzy_tpu_torch.service.InProcessCluster``:
the remote runtime, the workflow service, the graph executor, the
allocator, thread workers and device-resident channels over the durable
executor) held to the reference's (``lzy_tpu.service.InProcessCluster``),
in ONE test item that collects every failure and reports them together:

- ``RUNS``: the train-then-sample workflow (``build_corpus`` ->
  ``pretrain``, then two ``sample`` ops fanned out over two thread VMs,
  half of the prompts each) at a tiny Llama (2 layers, f32, CPU) on
  both clusters, from the same numpy-seeded weights carried across by
  ``models/convert.from_reference``. Losses agree within
  ``test_torch_train.py``'s tolerance and greedy tokens under the top-2
  rule, as in ``test_torch_workflow.py``; the port's remote run equals
  its local run (``LocalRuntime``) bit for bit: losses, params, tokens.
- ``CASES``: the cluster's semantics case by case, following
  ``tests/test_cluster.py``; each runs on both packages, each side on a
  cluster of its own, and must observe the same thing: a single op, a
  chained graph, a fan-out, VM reuse, an exception coming back with
  the remote traceback, the device channel (a torch tensor on the port,
  a ``jnp`` array on the reference, handed over as the same object),
  the server-side cache, std logs, finish tearing down, crash and
  resume through each side's own ``InjectedFailures``, the per-user
  task limit, environment variables, a failed graph releasing its user
  slots, and GC reaping through an injected clock (``now=``).
  Concurrency is shown with ``threading.Barrier``s that have a timeout,
  never with elapsed time. The gang and TPU-pool cases of
  ``tests/test_cluster.py`` are left out: the port's pools are one host
  each, and multi-device gangs are a later slice.
- port only: what the port does by design and the reference does not:
  module-level ops pickle by reference, the reference's options that
  this slice leaves out fail with ``TypeError``, and a consumer that
  changes a device-resident torch input in place fails with
  ``DeviceValueChanged`` (a ``jax.Array`` cannot change).

Rules: no socket, no subprocess, no wall-clock assertion; torch runs on
one thread. Every cluster gets its own ``tmp_path`` SQLite file and its
own ``mem://`` bucket; after each ``shutdown`` the set of live threads
must be back to what it was before the cluster (the port's shutdown
joins its threads itself; the reference's is given a bounded join
first). The reference's process-global ``InjectedFailures`` is cleared
after use, and ``sys.stdout``/``sys.stderr`` (which both packages' task
log routers wrap) are restored.

One item only: ``--dist loadfile`` queues files by their item count, and
a one-item file queues after every seed file.
"""

import contextlib
import dataclasses
import functools
import io
import os
import pickle
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
from lzy_tpu_torch.models.llama import LlamaConfig, init_params, make_loss_fn
from lzy_tpu_torch.storage.mem import MemStorageClient as PortMem

torch.set_num_threads(1)

VOCAB = 64
BATCH, SEQ = 2, 64
STEPS = 3
N_NEW = 8
#: test_torch_train.py's loss tolerance (f32, two layers)
ATOL, RTOL = 5e-6, 1e-5
#: test_torch_generate.py's greedy rule
GAP_TOL = 1e-3
#: a barrier whose parties never all arrive fails its ops after this
BARRIER_TIMEOUT_S = 60.0
#: bounded waits for asynchronous teardown (session deletion, threads)
SETTLE_S = 30.0

PROMPTS = np.random.default_rng(3).integers(0, VOCAB, (4, 11)).astype(np.int32)

# Module-level state the op bodies share with the test: thread workers
# run in this interpreter and resolve ops (and the functions inside
# them) by module reference, so these are the very same objects.
RAN = []                      # (package, op) per executed body
HEAVY_RUNS = []
SEEN = {}
BARRIERS = {}
CONCURRENCY = {"now": 0, "peak": 0}
CONCURRENCY_LOCK = threading.Lock()


@pytest.fixture(autouse=True)
def _process_state_unchanged(monkeypatch):
    """No case may change process-wide state that a test sharing this
    worker would read."""
    import jax

    from lzy_tpu.core.workflow import LzyWorkflow as RefWorkflow
    from lzy_tpu.durable import InjectedFailures as RefFailures
    from lzy_tpu_torch.core.workflow import LzyWorkflow
    from lzy_tpu_torch.durable import InjectedFailures

    def snap():
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        return (jax.config.jax_enable_x64, env, torch.get_default_dtype(),
                torch.is_grad_enabled(), RefWorkflow.get_active(),
                LzyWorkflow.get_active())

    jax.devices()
    import lzy_tpu.ops  # noqa: F401
    # both packages' task log routers wrap the streams they find
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    before = snap()
    yield
    RefFailures.clear()
    InjectedFailures.clear()
    PortMem.clear_all()
    assert snap() == before


def _packages():
    """Both packages' cluster surfaces behind one namespace each."""
    from lzy_tpu.core import workflow as ref_wf
    from lzy_tpu.durable import InjectedFailures as RefFailures
    from lzy_tpu.env.environment import LzyEnvironment as RefEnv
    from lzy_tpu.proxy import materialize as ref_materialize
    from lzy_tpu.service import InProcessCluster as RefCluster
    from lzy_tpu.storage import DefaultStorageRegistry as RefReg
    from lzy_tpu.storage import StorageConfig as RefConfig
    from lzy_tpu_torch.core import workflow as port_wf
    from lzy_tpu_torch.durable import InjectedFailures
    from lzy_tpu_torch.env import LzyEnvironment
    from lzy_tpu_torch.proxy import materialize
    from lzy_tpu_torch.service import InProcessCluster
    from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig

    ref = types.SimpleNamespace(
        name="reference", Cluster=RefCluster, op=lzy_tpu.op,
        Lzy=lzy_tpu.Lzy, RemoteCallError=ref_wf.RemoteCallError,
        Failures=RefFailures, Env=RefEnv, materialize=ref_materialize,
        Registry=RefReg, Config=RefConfig,
        # no container runtime probe: thread workers only
        cluster_kw=dict(container_runtime=None))
    port = types.SimpleNamespace(
        name="port", Cluster=InProcessCluster, op=lzy_tpu_torch.op,
        Lzy=lzy_tpu_torch.Lzy, RemoteCallError=port_wf.RemoteCallError,
        Failures=InjectedFailures, Env=LzyEnvironment,
        materialize=materialize, Registry=DefaultStorageRegistry,
        Config=StorageConfig, cluster_kw={})
    return ref, port


def _threads_left(before, join):
    """Threads alive now that were not before; ``join`` gives stopping
    threads a bounded join first."""
    if join:
        deadline = time.monotonic() + SETTLE_S
        for t in set(threading.enumerate()) - before:
            t.join(max(0.0, deadline - time.monotonic()))
    return sorted(t.name for t in set(threading.enumerate()) - before)


@contextlib.contextmanager
def _cluster(ns, tmp_path, fails, label, **kw):
    """A cluster of ``ns`` on its own SQLite file and ``mem://`` bucket;
    after its shutdown, no thread it started may be alive."""
    before = set(threading.enumerate())
    tag = f"{ns.name}-{uuid.uuid4().hex}"
    cluster = ns.Cluster(db_path=str(tmp_path / f"{tag}.db"),
                         storage_uri=f"mem://{tag}", **ns.cluster_kw, **kw)
    try:
        yield cluster
    finally:
        cluster.shutdown()
        left = _threads_left(before, join=ns.name == "reference")
        if left:
            fails.append(f"{label}: {ns.name} cluster left threads {left}")


def _wait_for(predicate, what):
    """Poll ``predicate`` until true; a bounded wait, not an assertion on
    how long it took."""
    deadline = time.monotonic() + SETTLE_S
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} did not happen in {SETTLE_S} s")
        time.sleep(0.01)


# -- the slice: train, then sample, fanned out ---------------------------------


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


def _corpus(seed):
    rng = np.random.default_rng(1000 + seed)
    return rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_grad_fn():
    import jax

    from lzy_tpu.models import llama as ref_llama

    return jax.jit(jax.value_and_grad(ref_llama.make_loss_fn(_ref_cfg())))


@lzy_tpu.op(cache=True, version="1")
def ref_build_corpus(seed: int) -> np.ndarray:
    RAN.append(("reference", "build_corpus"))
    return _corpus(seed)


@lzy_tpu.op(cache=True, version="1")
def ref_pretrain(corpus: np.ndarray, init: dict,
                 steps: int) -> tuple[dict, list]:
    """optax AdamW over ``jax.value_and_grad`` of the reference's loss,
    as ``test_torch_train.py`` builds it."""
    import jax
    import jax.numpy as jnp
    import optax

    RAN.append(("reference", "pretrain"))
    tx = optax.adamw(3e-4)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(params)
    losses = []
    for _ in range(steps):
        loss, grads = _ref_grad_fn()(params, {"tokens": jnp.asarray(corpus)})
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params), losses


@lzy_tpu.op(cache=True, version="1")
def ref_sample(trained: dict, prompts: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from lzy_tpu.models.generate import generate

    RAN.append(("reference", "sample"))
    out = generate(_ref_cfg(), trained, jnp.asarray(prompts),
                   max_new_tokens=N_NEW, prefill_chunk=8)
    return np.asarray(out)[:, prompts.shape[1]:]


@lzy_tpu_torch.op(cache=True, version="1")
def port_build_corpus(seed: int) -> torch.Tensor:
    RAN.append(("port", "build_corpus"))
    return torch.from_numpy(_corpus(seed))


@lzy_tpu_torch.op(cache=True, version="1")
def port_pretrain(corpus: torch.Tensor, init: dict,
                  steps: int) -> tuple[dict, list]:
    """``parallel.train``'s step with its AdamW."""
    from lzy_tpu_torch.parallel.train import TrainState, adamw, make_train_step

    RAN.append(("port", "pretrain"))
    cfg = _port_cfg()
    model = convert.load_reference(
        init_params(cfg, device="cpu", trainable=True), init)
    state = TrainState.create(model, adamw(3e-4))
    step = make_train_step(make_loss_fn(cfg))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, {"tokens": corpus})
        losses.append(float(metrics["loss"]))
    params = dict(state.model.state_dict())
    SEEN["pretrain_params"] = params["embed_tokens"].data_ptr()
    return params, losses


@lzy_tpu_torch.op(cache=True, version="1")
def port_sample(trained: dict, prompts: torch.Tensor) -> torch.Tensor:
    """Greedy requests through the paged engine."""
    from lzy_tpu_torch.models.llama import Llama
    from lzy_tpu_torch.serving.engine import PagedInferenceEngine

    RAN.append(("port", "sample"))
    SEEN.setdefault("sample_params", []).append(
        trained["embed_tokens"].data_ptr())
    model = Llama(_port_cfg(), "cpu")
    model.load_state_dict(trained)
    engine = PagedInferenceEngine(model, slots=2, page_size=4)
    reqs = [engine.submit(p.tolist(), max_new_tokens=N_NEW) for p in prompts]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        engine.step()
    return torch.tensor([r.result(0) for r in reqs], dtype=torch.int32)


def _run_slice(ns, lzy, init, inside=lambda: None):
    """build_corpus -> pretrain (graph 1, forced by reading the losses),
    then two samples, half of the prompts each (graph 2): the losses, the
    trained params, the tokens in prompt order, the ops executed, and
    what ``inside()`` saw before the workflow finished."""
    if ns.name == "reference":
        build_corpus, pretrain, sample = ref_build_corpus, ref_pretrain, ref_sample
        halves = (PROMPTS[:2], PROMPTS[2:])
    else:
        build_corpus, pretrain, sample = (port_build_corpus, port_pretrain,
                                          port_sample)
        halves = (torch.from_numpy(PROMPTS[:2]), torch.from_numpy(PROMPTS[2:]))
    del RAN[:]
    with lzy.workflow("llama_workflow"):
        trained, losses = pretrain(build_corpus(0), init, STEPS)
        losses = [float(x) for x in ns.materialize(losses)]
        outs = [sample(trained, half) for half in halves]
        tokens = np.concatenate([np.asarray(ns.materialize(o)) for o in outs])
        params = ns.materialize(trained)
        seen = inside()
    return dict(losses=losses, params=params, tokens=tokens.tolist(),
                ran=sorted(name for pkg, name in RAN if pkg == ns.name),
                inside=seen)


def _top2_failures(label, want, got, trained_params):
    """Greedy port tokens against the reference's, under the top-2 rule
    on the reference's logits over its own continuation."""
    import jax.numpy as jnp

    from lzy_tpu.models.llama import Llama as RefLlama

    fails = []
    seq = np.concatenate([PROMPTS, np.asarray(want, np.int32)], axis=1)
    logits = np.asarray(RefLlama(_ref_cfg()).apply(
        {"params": trained_params}, jnp.asarray(seq)))
    t0 = PROMPTS.shape[1]
    for row, (w, g) in enumerate(zip(want, got)):
        for i, (a, b) in enumerate(zip(w, g)):
            if a != b:
                top2 = np.sort(logits[row, t0 - 1 + i])[-2:]
                gap = float(top2[1] - top2[0])
                if gap >= GAP_TOL:
                    fails.append(f"{label}: row {row} diverges at step {i} "
                                 f"where the reference's top-2 gap is {gap}")
                break
    return fails


def _vms_and_hits(c):
    """Op name -> the VMs its tasks ran on, over the running execution's
    graphs; and the inputs its tasks took from the device peer."""
    vms, hits = {}, 0
    for doc in c.store.kv_list("executions").values():
        for graph in doc["graphs"]:
            for t in c.graph_executor.task_timings(graph):
                vms.setdefault(t["name"], []).extend(t["vm_ids"])
                hits += t["device_hits"]
    return vms, hits


def _slice_case(tmp_path):
    ref, port = _packages()
    init = _init_tree()
    fails = []
    runs = {}
    for ns in (ref, port):
        SEEN.clear()
        with _cluster(ns, tmp_path, fails, "slice") as c:
            probe = (functools.partial(_vms_and_hits, c)
                     if ns is port else (lambda: None))
            runs[ns.name] = _run_slice(ns, c.lzy(), init, probe)
    pointers = (SEEN.get("pretrain_params"),
                list(SEEN.get("sample_params", [])))
    reg = port.Registry()
    reg.register_storage("default",
                         port.Config(uri=f"mem://local-{uuid.uuid4().hex}"))
    local = _run_slice(port, port.Lzy(storage_registry=reg), init)
    r, p = runs["reference"], runs["port"]
    expected = ["build_corpus", "pretrain", "sample", "sample"]
    for name, run in (("reference", r), ("port", p), ("port local", local)):
        if run["ran"] != expected:
            fails.append(f"slice: {name} executed {run['ran']}")
    if not np.allclose(p["losses"], r["losses"], atol=ATOL, rtol=RTOL):
        fails.append(f"slice: losses {p['losses']} (port) vs {r['losses']} "
                     f"(reference)")
    fails += _top2_failures("slice", r["tokens"], p["tokens"], r["params"])
    # the port's remote run against its local run: the same bits
    if local["losses"] != p["losses"] or local["tokens"] != p["tokens"]:
        fails.append(f"slice: port remote {p['losses']} {p['tokens']} vs "
                     f"local {local['losses']} {local['tokens']}")
    if list(local["params"]) != list(p["params"]) or not all(
            torch.equal(local["params"][k], p["params"][k])
            for k in p["params"]):
        fails.append("slice: port remote params differ from the local run's")
    # graph 2 reused graph 1's idle VM; and pretrain's params reached
    # both samples through the device peer, the same memory (hits: the
    # corpus into pretrain, the params twice)
    vms, hits = p["inside"]
    if not set(vms["port_pretrain"]) & set(vms["port_sample"]) or hits != 3:
        fails.append(f"slice: VMs {vms}, device hits {hits} (expected 3)")
    if pointers[1] != [pointers[0]] * 2:
        fails.append(f"slice: pretrain's params at {pointers[0]}, the "
                     f"samples' at {pointers[1]}")
    return fails


# -- the cluster's semantics, case by case -------------------------------------
# Each case takes a package namespace and a running cluster and returns
# what it observed; the port must observe what the reference does. Op
# bodies are module-level functions, wrapped per package.


def _inc(x: int) -> int:
    return x + 1


def _add(a: int, b: int) -> int:
    return a + b


def _meet(i: int) -> int:
    """Passes only once every party of the fan-out barrier has arrived."""
    BARRIERS["fanout"].wait()
    return i


def _tracked(i: int) -> int:
    with CONCURRENCY_LOCK:
        CONCURRENCY["now"] += 1
        CONCURRENCY["peak"] = max(CONCURRENCY["peak"], CONCURRENCY["now"])
    BARRIERS["pair"].wait()
    with CONCURRENCY_LOCK:
        CONCURRENCY["now"] -= 1
    return i


def _heavy(x: int) -> int:
    HEAVY_RUNS.append(x)
    return x * 2


def _explode(x: int) -> int:
    raise ValueError(f"bad value {x}")


def _chatty() -> int:
    print("hello from the worker")
    return 1


def _read_env_var() -> str:
    return os.environ.get("LZY_TEST_FLAVOR", "unset")


def _produce_torch() -> torch.Tensor:
    x = torch.full((8, 8), 3.0, dtype=torch.bfloat16)
    SEEN["produced"] = id(x)
    return x


def _consume_torch(x: torch.Tensor) -> float:
    SEEN["consumed"] = id(x)
    return float(x.float().sum())


def _mutate_torch(x: torch.Tensor) -> float:
    """Changes its input in place: on the device path that input is the
    producer's own tensor."""
    return float(x.add_(1.0).float().sum())


def _produce_jax():
    import jax.numpy as jnp

    x = jnp.full((8, 8), 3.0, jnp.bfloat16)
    SEEN["produced"] = id(x)
    return x


def _consume_jax(x) -> float:
    import jax.numpy as jnp

    SEEN["consumed"] = id(x)
    return float(jnp.float32(x).sum())


def _single_op(ns, c):
    inc = ns.op(_inc)
    with c.lzy().workflow("wf"):
        return [inc(41) + 0]


def _chained_graph(ns, c):
    inc, add = ns.op(_inc), ns.op(_add)
    with c.lzy().workflow("wf"):
        return [add(inc(1), inc(2)) + 0]


def _fan_out(ns, c):
    """Four ops must all be running at once for any of them to finish."""
    meet = ns.op(_meet)
    BARRIERS["fanout"] = threading.Barrier(4, timeout=BARRIER_TIMEOUT_S)
    with c.lzy().workflow("sweep"):
        total = sum(int(r) for r in [meet(i) for i in range(4)])
        return [total, len(c.allocator.vms())]


def _vm_reuse(ns, c):
    inc = ns.op(_inc)
    with c.lzy().workflow("wf"):
        a = inc(1) + 0              # graph 1 allocates a VM
        b = inc(a) + 0              # graph 2 must reuse the idle one
        return [a, b, len(c.allocator.vms())]


def _exception(ns, c):
    explode = ns.op(_explode)
    try:
        with c.lzy().workflow("wf"):
            _ = explode(7) + 1
    except ns.RemoteCallError as e:
        cause = e.__cause__
        return [type(cause).__name__, str(cause),
                any("remote traceback" in n
                    for n in getattr(cause, "__notes__", []))]
    return "not raised"


def _device_channel(ns, c):
    """The consumer gets the producer's value itself (the same object,
    from the device peer), not a copy through storage."""
    produce, consume = ((ns.op(_produce_jax), ns.op(_consume_jax))
                        if ns.name == "reference" else
                        (ns.op(_produce_torch), ns.op(_consume_torch)))
    SEEN.clear()
    with c.lzy().workflow("wf"):
        out = consume(produce()) + 0.0
    return [out, SEEN["produced"] == SEEN["consumed"]]


def _server_side_cache(ns, c):
    heavy = ns.op(cache=True, version="1.0")(_heavy)
    del HEAVY_RUNS[:]
    lzy = c.lzy()
    out = []
    for _ in range(2):
        with lzy.workflow("wf"):
            out.append(heavy(5) + 0)
    return [out, list(HEAVY_RUNS)]


def _std_logs(ns, c):
    chatty = ns.op(_chatty)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        with c.lzy(stream_logs=True).workflow("wf"):
            r = chatty() + 0
    text = err.getvalue()
    return [r, "[LZY-REMOTE-" in text, "hello from the worker" in text]


def _finish_tears_down(ns, c):
    inc = ns.op(_inc)
    with c.lzy().workflow("wf"):
        inc(1)
    docs = c.store.kv_list("executions")
    # session deletion runs as a durable op after finish
    _wait_for(lambda: not c.allocator.vms(), "session VM teardown")
    return [[d["status"] for d in docs.values()], c.allocator.vms()]


def _crash_and_resume(ns, c):
    """Crash the graph scheduler on its first round (its durable op stays
    RUNNING, as after a killed process), then restore: the graph resumes
    and completes."""
    inc, add = ns.op(_inc), ns.op(_add)
    ns.Failures.arm("exec_graph.schedule")
    lzy = c.lzy()
    done = {}

    def run():
        with lzy.workflow("wf"):
            done["result"] = int(add(inc(1), inc(2)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait_for(lambda: not ns.Failures.armed(), "the injected crash")
    parked = "result" in done
    # the crashed op counts as resumed once its driver has let go of it
    resumed = []
    _wait_for(lambda: resumed.append(c.resume_pending_operations())
              or resumed[-1] > 0, "resuming the parked graph")
    t.join(SETTLE_S)
    return [parked, resumed[-1], done.get("result")]


def _per_user_limit(ns, c):
    """With a per-user limit of 2, ops meet in pairs and never 3 run."""
    c.graph_executor.max_running_tasks_per_user = 2
    tracked = ns.op(_tracked)
    CONCURRENCY.update(now=0, peak=0)
    BARRIERS["pair"] = threading.Barrier(2, timeout=BARRIER_TIMEOUT_S)
    with c.lzy().workflow("limited"):
        total = sum(int(r) for r in [tracked(i) for i in range(6)])
    return [total, CONCURRENCY["peak"]]


def _env_vars(ns, c):
    read_env_var = ns.op(_read_env_var)
    with c.lzy().workflow(
            "env-wf", env=ns.Env(env_vars={"LZY_TEST_FLAVOR": "vanilla"})):
        seen = str(read_env_var())
    return [seen, os.environ.get("LZY_TEST_FLAVOR")]


def _failed_graph_releases_slots(ns, c):
    c.graph_executor.max_running_tasks_per_user = 2
    explode, inc = ns.op(_explode), ns.op(_inc)
    lzy = c.lzy()
    try:
        with lzy.workflow("fails"):
            _ = explode(1) + 1
        raised = False
    except ns.RemoteCallError:
        raised = True
    with lzy.workflow("after"):
        r = inc(1) + 0
    return [raised, r, c.graph_executor._user_running.get("test-user", 0)]


def _gc_reaps(ns, c):
    """An execution left ACTIVE with an idle VM: GC ticks at an injected
    time past the session's idle timeout and the execution TTL reap the
    VM and abort the execution."""
    inc = ns.op(_inc)
    wf = c.lzy().workflow("gc-wf")
    wf.__enter__()
    try:
        r = inc(1) + 0
        later = time.time() + 7200.0        # past the 21 min idle timeout
        vms = c.allocator.gc_tick(now=later)
        reaped = c.workflow_service.gc_tick(ttl_s=3600.0, now=later)
        status = c.store.kv_get("executions", wf.execution_id)["status"]
        seen = [r, len(vms), c.allocator.vms(),
                reaped == [wf.execution_id], status]
    finally:
        wf.__exit__(None, None, None)
    return seen


CASES = {
    "single op": (_single_op, {}),
    "chained graph": (_chained_graph, {}),
    "fan-out": (_fan_out, {}),
    "VM reuse across graphs": (_vm_reuse, {}),
    "exception propagates": (_exception, {}),
    "device channel": (_device_channel, {}),
    "server-side cache": (_server_side_cache, {}),
    "std logs reach the client": (_std_logs, {}),
    "finish tears down": (_finish_tears_down, {}),
    "crash and resume": (_crash_and_resume, {}),
    "per-user task limit": (_per_user_limit, {}),
    "env vars": (_env_vars, {}),
    "failed graph releases user slots": (_failed_graph_releases_slots, {}),
    # the GC thread exists (and is joined at shutdown) but never ticks
    "GC reaps through an injected clock": (_gc_reaps,
                                           {"gc_period_s": 3600.0}),
}


def _port_only_cases(tmp_path):
    """What the port does differently, by design."""
    ref, port = _packages()
    fails = []
    # a module-level op pickles by reference with plain pickle
    payload = pickle.dumps(port_sample)
    if pickle.loads(payload) is not port_sample or len(payload) > 200:
        fails.append(f"port_sample pickles by value ({len(payload)} bytes)")
    # the reference's options that this slice does not port are unknown
    for kw in ("worker_mode", "with_iam", "p2p_spill_root",
               "container_runtime", "backend", "leader_lease_ttl_s",
               "inference_service", "vm_boot_delay_s", "pools", "workers",
               "max_running_tasks", "poll_period_s", "execution_ttl_s"):
        try:
            port.Cluster(**{kw: None})
            fails.append(f"port InProcessCluster({kw}=) accepted")
        except TypeError:
            pass
    try:
        port.Cluster(db_path="postgresql://nowhere/db")
        fails.append("port InProcessCluster took a Postgres DSN")
    except ValueError:
        pass
    with _cluster(port, tmp_path, fails, "port only") as c:
        for kw in ("token", "user", "poll_period_s"):
            try:
                c.lzy(**{kw: "t"})
                fails.append(f"port lzy({kw}=) accepted")
            except TypeError:
                pass
        try:
            c.lzy().workflow("wf", interactive=False)
            fails.append("port workflow(interactive=) accepted")
        except TypeError:
            pass
        fails += _in_place_change(port, c)
    return fails


def _in_place_change(port, c):
    """A consumer that changes a device-resident input in place fails
    with ``DeviceValueChanged`` (the producer's tensor is shared by its
    storage copy and every other consumer); the local runtime hands each
    consumer a copy, so there the same op succeeds."""
    from lzy_tpu_torch.channels.manager import DeviceValueChanged

    produce, mutate = port.op(_produce_torch), port.op(_mutate_torch)
    fails = []
    try:
        with c.lzy().workflow("wf"):
            _ = mutate(produce()) + 0.0
        fails.append("in-place change: a consumer changed its device "
                     "input and the graph succeeded")
    except port.RemoteCallError as e:
        cause = e.__cause__
        if not isinstance(cause, DeviceValueChanged) or not any(
                "remote traceback" in n
                for n in getattr(cause, "__notes__", [])):
            fails.append(f"in-place change: raised {cause!r}")
    reg = port.Registry()
    reg.register_storage("default",
                         port.Config(uri=f"mem://local-{uuid.uuid4().hex}"))
    with port.Lzy(storage_registry=reg).workflow("wf"):
        local = mutate(produce()) + 0.0
    if local != 4.0 * 64:
        fails.append(f"in-place change: local run gave {local}")
    return fails


def test_cluster_slice_and_cases_match_reference(tmp_path):
    ref, port = _packages()
    fails = _slice_case(tmp_path)
    for label, (case, kw) in CASES.items():
        got = {}
        for ns in (ref, port):
            with _cluster(ns, tmp_path, fails, label, **kw) as c:
                try:
                    got[ns.name] = case(ns, c)
                except Exception as e:  # noqa: BLE001 — reported per case
                    got[ns.name] = f"raised {type(e).__name__}: {e}"
        if got["reference"] != got["port"]:
            fails.append(f"{label}: reference {got['reference']!r}, port "
                         f"{got['port']!r}")
    fails += _port_only_cases(tmp_path)
    assert not fails, "\n".join(fails)
