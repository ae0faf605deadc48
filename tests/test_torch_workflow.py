"""The port's workflow SDK (``lzy_tpu_torch.core``, ``runtime``,
``snapshot``, ``storage``, ``whiteboards``) held to the JAX reference's
(``lzy_tpu``), in ONE test item that runs two parts, collects every
failure and reports them together:

- ``RUNS``: the train-then-sample workflow of the slice
  (``build_corpus`` -> ``pretrain`` -> ``sample``, a whiteboard per run)
  at a tiny Llama (2 layers, f32, CPU) on both packages, from the same
  numpy-seeded weights carried across by ``models/convert``: the
  reference trains with ``jax.value_and_grad`` of its loss and optax's
  AdamW, as ``tests/test_torch_train.py`` builds it, and samples with
  its ``generate()``; the port trains with ``parallel.train`` and samples
  from its paged engine. Losses agree within ``test_torch_train``'s loss
  tolerance, greedy tokens under the top-2 rule; both sides run the same
  ops on a first run, a cached re-run, a re-run after a version bump and
  one after an input change; whiteboard queries agree.
- ``SDK_CASES``: the SDK's semantics case by case with plain-Python ops,
  following ``tests/test_workflow_local.py``; each case runs on both
  packages and must observe the same thing. ``@op(tpu=...)`` and the
  reference's options that nothing in the port calls yet are refused by
  the port only.

One item only: ``--dist loadfile`` queues files by their item count, and
a one-item file queues after every seed file.

Storage stays inside this test: the reference on ``mem://`` buckets its
own conftest clears, the port on the port's own ``mem://`` store, cleared
by a fixture here; nothing uses a default storage root. ``lzy_auth`` runs
only under ``monkeypatch``.
"""

import dataclasses
import os
import types
import uuid

import numpy as np
import pytest
import torch

import lzy_tpu_torch
from lzy_tpu_torch.models import convert
from lzy_tpu_torch.models.llama import LlamaConfig, init_params, make_loss_fn
from lzy_tpu_torch.storage.mem import MemStorageClient as PortMem

torch.set_num_threads(1)

VOCAB = 64
BATCH, SEQ = 2, 64
STEPS = 3
N_NEW = 8
#: test_torch_train.py's loss tolerance (f32, two layers, sums in other
#: orders; measured there within 1e-6)
ATOL, RTOL = 5e-6, 1e-5
#: test_torch_generate.py's greedy rule: a divergence only where the
#: reference's top-2 logit gap is below this
GAP_TOL = 1e-3
WB_NAME = "llama_workflow_run"


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """No case may change process-wide state that a test sharing this
    worker would read; the port's mem store is emptied afterwards."""
    import jax

    from lzy_tpu.core.workflow import LzyWorkflow as RefWorkflow
    from lzy_tpu_torch.core.workflow import LzyWorkflow

    def snap():
        env = {k: v for k, v in os.environ.items()
               if k != "PYTEST_CURRENT_TEST"}
        return (jax.config.jax_enable_x64,
                jax.config.jax_default_matmul_precision, env,
                torch.get_default_dtype(), torch.is_grad_enabled(),
                RefWorkflow.get_active(), LzyWorkflow.get_active())

    # the backend's first start, and importing Pallas (its GPU backend:
    # the reference's model imports ``lzy_tpu.ops`` when first called),
    # set variables of their own
    jax.devices()
    import lzy_tpu.ops  # noqa: F401
    before = snap()
    yield
    PortMem.clear_all()
    assert snap() == before


def _packages():
    """Both SDKs behind one namespace each."""
    import lzy_tpu
    from lzy_tpu.core import workflow as ref_wf
    from lzy_tpu.env.environment import LzyEnvironment as RefEnv
    from lzy_tpu.proxy import is_lzy_proxy as ref_is_proxy
    from lzy_tpu.proxy import materialize as ref_materialize
    from lzy_tpu.proxy import materialized as ref_materialized
    from lzy_tpu.runtime.local import LocalRuntime as RefLocal
    from lzy_tpu.storage import DefaultStorageRegistry as RefReg
    from lzy_tpu.storage import StorageConfig as RefConfig
    from lzy_tpu_torch.core import workflow as port_wf
    from lzy_tpu_torch.env import LzyEnvironment
    from lzy_tpu_torch.proxy import is_lzy_proxy, materialize, materialized
    from lzy_tpu_torch.runtime import LocalRuntime
    from lzy_tpu_torch.storage import DefaultStorageRegistry, StorageConfig

    ref = types.SimpleNamespace(
        name="reference", pkg=lzy_tpu, Lzy=lzy_tpu.Lzy, op=lzy_tpu.op,
        whiteboard=lzy_tpu.whiteboard, lzy_auth=lzy_tpu.lzy_auth,
        WorkflowError=ref_wf.WorkflowError,
        RemoteCallError=ref_wf.RemoteCallError, Env=RefEnv,
        is_proxy=ref_is_proxy, materialized=ref_materialized,
        materialize=ref_materialize,
        LocalRuntime=RefLocal, Registry=RefReg, Config=RefConfig)
    port = types.SimpleNamespace(
        name="port", pkg=lzy_tpu_torch, Lzy=lzy_tpu_torch.Lzy,
        op=lzy_tpu_torch.op, whiteboard=lzy_tpu_torch.whiteboard,
        lzy_auth=lzy_tpu_torch.lzy_auth,
        WorkflowError=port_wf.WorkflowError,
        RemoteCallError=port_wf.RemoteCallError, Env=LzyEnvironment,
        is_proxy=is_lzy_proxy, materialized=materialized,
        materialize=materialize,
        LocalRuntime=LocalRuntime, Registry=DefaultStorageRegistry,
        Config=StorageConfig)
    return ref, port


def _storage(ns, uri=None):
    """A registry over a fresh ``mem://`` bucket (or ``uri``)."""
    reg = ns.Registry()
    reg.register_storage(
        "default", ns.Config(uri=uri or f"mem://{ns.name}-{uuid.uuid4().hex}"),
        default=True)
    return reg


def _lzy(ns, uri=None, **kw):
    return ns.Lzy(storage_registry=_storage(ns, uri), **kw)


def _raised(fn):
    """``(exception type name, message)`` of what ``fn`` raises, or
    ``("returned", value)``."""
    try:
        return ("returned", fn())
    except Exception as e:  # noqa: BLE001 — the observation under test
        return (type(e).__name__, str(e))


# -- the slice: train, then sample, on both packages --------------------------


def _init_tree():
    """Reference-layout weights from a numpy seed (shapes from the port's
    tiny model mapped through ``convert.to_reference``)."""
    cfg = _port_cfg()
    shapes = convert.to_reference(init_params(cfg, device="cpu").state_dict(),
                                  cfg)
    rng = np.random.default_rng(7)

    def draw(path, x):
        if path.endswith("scale"):
            return np.ones_like(x)
        std = 0.02 if path == "embed_tokens" else 1.0 / np.sqrt(x.shape[0])
        return (rng.standard_normal(x.shape) * std).astype(np.float32)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        return draw(path, tree)

    return walk(shapes)


def _port_cfg():
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32,
                               param_dtype=torch.float32)


def _ref_cfg():
    import jax.numpy as jnp

    from lzy_tpu.models import llama as ref_llama

    return dataclasses.replace(ref_llama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)


def _corpus(seed):
    rng = np.random.default_rng(1000 + seed)
    return rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)


PROMPTS = np.random.default_rng(3).integers(0, VOCAB, (3, 11)).astype(np.int32)


def _reference_ops(init, ran):
    """The slice's three ops on the reference: optax AdamW over
    ``jax.value_and_grad`` of the loss (no mesh, no donation)."""
    import jax
    import jax.numpy as jnp
    import optax

    from lzy_tpu import op
    from lzy_tpu.models import llama as ref_llama
    from lzy_tpu.models.generate import generate

    rcfg = _ref_cfg()
    grad_fn = jax.jit(jax.value_and_grad(ref_llama.make_loss_fn(rcfg)))

    @op(cache=True, version="1")
    def build_corpus(seed: int) -> np.ndarray:
        ran.append("build_corpus")
        return _corpus(seed)

    def pretrain(corpus: np.ndarray, steps: int) -> tuple[dict, list]:
        ran.append("pretrain")
        tx = optax.adamw(3e-4)
        params = jax.tree_util.tree_map(jnp.asarray, init)
        opt_state = tx.init(params)
        losses = []
        for _ in range(steps):
            loss, grads = grad_fn(params, {"tokens": jnp.asarray(corpus)})
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return jax.tree_util.tree_map(np.asarray, params), losses

    @op(cache=True, version="1")
    def sample(trained: dict, prompts: np.ndarray) -> np.ndarray:
        ran.append("sample")
        out = generate(rcfg, trained, jnp.asarray(prompts),
                       max_new_tokens=N_NEW, prefill_chunk=8)
        return np.asarray(out)[:, prompts.shape[1]:]

    return build_corpus, pretrain, sample


def _port_ops(init, ran):
    """The slice's three ops on the port: ``parallel.train``'s step with
    its AdamW, then greedy requests through the paged engine."""
    from lzy_tpu_torch import op
    from lzy_tpu_torch.models.llama import Llama
    from lzy_tpu_torch.parallel.train import TrainState, adamw, make_train_step
    from lzy_tpu_torch.serving.engine import PagedInferenceEngine

    cfg = _port_cfg()

    @op(cache=True, version="1")
    def build_corpus(seed: int) -> torch.Tensor:
        ran.append("build_corpus")
        return torch.from_numpy(_corpus(seed))

    def pretrain(corpus: torch.Tensor, steps: int) -> tuple[dict, list]:
        ran.append("pretrain")
        model = convert.load_reference(
            init_params(cfg, device="cpu", trainable=True), init)
        state = TrainState.create(model, adamw(3e-4))
        step = make_train_step(make_loss_fn(cfg))
        losses = []
        for _ in range(steps):
            state, metrics = step(state, {"tokens": corpus})
            losses.append(float(metrics["loss"]))
        return dict(state.model.state_dict()), losses

    @op(cache=True, version="1")
    def sample(trained: dict, prompts: torch.Tensor) -> torch.Tensor:
        ran.append("sample")
        model = Llama(cfg, "cpu")
        model.load_state_dict(trained)
        engine = PagedInferenceEngine(model, slots=2, page_size=4)
        reqs = [engine.submit(p.tolist(), max_new_tokens=N_NEW)
                for p in prompts]
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            engine.step()
        return torch.tensor([r.result(0) for r in reqs], dtype=torch.int32)

    return build_corpus, pretrain, sample


#: (label, corpus seed, pretrain version, ops the run must execute)
RUNS = [
    ("first run", 0, "1", {"build_corpus", "pretrain", "sample"}),
    ("cached re-run", 0, "1", set()),
    ("version bump", 0, "2", {"pretrain", "sample"}),
    ("input change", 1, "2", {"build_corpus", "pretrain", "sample"}),
]


def _run_slice(ns, ops, ran, lzy):
    """The four runs of one package: per run the ops executed, the
    losses, the sampled tokens and the trained params. ``pretrain`` is
    decorated per run, with the run's version."""
    build_corpus, pretrain_fn, sample = ops

    @ns.whiteboard(WB_NAME)
    @dataclasses.dataclass
    class Run:
        losses: list
        final_loss: float
        tokens: object

    prompts = PROMPTS if ns.name == "reference" else torch.from_numpy(PROMPTS)
    out = []
    for label, seed, version, _ in RUNS:
        pretrain = ns.op(cache=True, version=version)(pretrain_fn)
        del ran[:]
        with lzy.workflow("llama_workflow") as wf:
            trained, losses = pretrain(build_corpus(seed), STEPS)
            tokens = sample(trained, prompts)
            wb = wf.create_whiteboard(
                Run, tags=[f"seed:{seed}", f"pretrain:v{version}"])
            wb.losses = losses
            wb.tokens = tokens
            wb.final_loss = float(losses[-1])
        out.append(dict(ran=set(ran), losses=[float(x) for x in losses],
                        tokens=np.asarray(tokens).tolist(),
                        params=ns.materialize(trained)))
    return out


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


def _slice_case():
    ref, port = _packages()
    init = _init_tree()
    ref_ran, port_ran = [], []
    ref_lzy, port_lzy = _lzy(ref), _lzy(port)
    ref_runs = _run_slice(ref, _reference_ops(init, ref_ran), ref_ran,
                          ref_lzy)
    port_runs = _run_slice(port, _port_ops(init, port_ran), port_ran,
                           port_lzy)
    fails = []
    for run, r, p in zip(RUNS, ref_runs, port_runs):
        label, expected = run[0], run[3]
        if not r["ran"] == p["ran"] == expected:
            fails.append(f"{label}: executed ops: reference "
                         f"{sorted(r['ran'])}, port {sorted(p['ran'])}, "
                         f"expected {sorted(expected)}")
        if not np.allclose(p["losses"], r["losses"], atol=ATOL, rtol=RTOL):
            fails.append(f"{label}: losses {p['losses']} (port) vs "
                         f"{r['losses']} (reference)")
        fails += _top2_failures(label, r["tokens"], p["tokens"], r["params"])
    # whiteboards: the same queries find the same runs on both sides
    for query in (dict(name=WB_NAME), dict(name=WB_NAME, tags=["seed:0"]),
                  dict(name=WB_NAME, tags=["seed:0", "pretrain:v2"]),
                  dict(tags=["seed:1"]), dict(name="missing")):
        got = {}
        for ns, lzy in ((ref, ref_lzy), (port, port_lzy)):
            got[ns.name] = [(sorted(w.tags), list(w.losses), w.final_loss)
                            for w in lzy.whiteboards(**query)]
        r, p = got["reference"], got["port"]
        if [x[0] for x in r] != [x[0] for x in p]:
            fails.append(f"whiteboards({query}): tags {[x[0] for x in r]} "
                         f"(reference) vs {[x[0] for x in p]} (port)")
            continue
        for (_, rl, rf), (_, pl, pf) in zip(r, p):
            if not (np.allclose(pl, rl, atol=ATOL, rtol=RTOL)
                    and abs(pf - rf) <= ATOL + RTOL * abs(rf)):
                fails.append(f"whiteboards({query}): losses {pl} / {pf} "
                             f"(port) vs {rl} / {rf} (reference)")
    # the last run's whiteboard, read back through a fresh Lzy
    fresh = port.Lzy(storage_registry=port_lzy.storage_registry)
    last = fresh.whiteboards(name=WB_NAME, tags=["seed:1"])
    if len(last) != 1 or np.asarray(last[0].tokens).tolist() != \
            port_runs[-1]["tokens"]:
        fails.append("a fresh port Lzy does not read back the last run's "
                     "tokens")
    return fails


# -- the SDK's semantics, case by case ----------------------------------------
# Each case takes a package namespace and returns what it observed; the
# port must observe what the reference does.


def _proxies_and_laziness(ns):
    @ns.op
    def inc(x: int) -> int:
        return x + 1

    with _lzy(ns).workflow("wf"):
        r = inc(1)
        seen = [ns.is_proxy(r), ns.materialized(r)]
        seen += [r == 2, ns.materialized(r), isinstance(r, int)]
    return seen + [inc(1)]      # outside a workflow: a plain call


def _chained_and_multi_output(ns):
    @ns.op
    def add(a: int, b: int) -> int:
        return a + b

    @ns.op
    def duo(x: int) -> tuple[int, str]:
        return x * 2, f"v{x}"

    with _lzy(ns).workflow("wf"):
        total = add(add(1, 2), 4)
        a, b = duo(21)
        return [total + 0, a + 0, str(b)]


def _barrier_on_exit(ns):
    log = []

    @ns.op
    def record(x: int) -> int:
        log.append(x)
        return x

    with _lzy(ns).workflow("wf"):
        record(5)
        before = list(log)
    return [before, log]


def _op_exception(ns):
    @ns.op
    def boom() -> int:
        raise ValueError("inner failure")

    try:
        with _lzy(ns).workflow("wf"):
            _ = boom() + 1
    except ns.RemoteCallError as e:
        cause = e.__cause__
        return [type(cause).__name__, str(cause),
                any("remote traceback" in n
                    for n in getattr(cause, "__notes__", []))]
    return "not raised"


def _type_validation(ns):
    @ns.op
    def inc(x: int) -> int:
        return x + 1

    def run():
        with _lzy(ns).workflow("wf"):
            inc("not an int")

    return _raised(run)


def _bool_and_none_eager(ns):
    @ns.op
    def check(x: int) -> bool:
        return x > 0

    @ns.op
    def nothing() -> None:
        return None

    with _lzy(ns).workflow("wf"):
        return [check(3) is True, nothing() is None]


def _env_vars(ns):
    @ns.op(env=ns.Env(env_vars={"LZY_PORT_TEST_FLAVOR": "mint"}))
    def flavor() -> str:
        return os.environ.get("LZY_PORT_TEST_FLAVOR", "unset")

    with _lzy(ns).workflow("wf"):
        inside = str(flavor())
    return [inside, os.environ.get("LZY_PORT_TEST_FLAVOR")]


def _optional_annotations(ns):
    from typing import Optional

    @ns.op
    def maybe(x: Optional[int]) -> Optional[int]:
        return x

    with _lzy(ns).workflow("wf"):
        return maybe(5) + 0


def _failed_exit_barrier_aborts(ns):
    events = []

    class Spy(ns.LocalRuntime):
        def finish(self, workflow):
            events.append("finish")

        def abort(self, workflow):
            events.append("abort")

    @ns.op
    def boom() -> int:
        raise ValueError("late failure")

    try:
        with _lzy(ns, runtime=Spy()).workflow("wf"):
            boom()
    except ns.RemoteCallError:
        events.append("raised")
    return events


def _lazy_arguments_false(ns):
    order = []

    @ns.op
    def produce() -> int:
        order.append("produce")
        return 1

    @ns.op(lazy_arguments=False)
    def consume(x: int) -> int:
        order.append("consume")
        return x

    with _lzy(ns).workflow("wf"):
        p = produce()
        order.append("registering-consume")
        consume(p)
    return order


def _nested_workflow(ns):
    lzy = _lzy(ns)
    with lzy.workflow("outer"):
        return _raised(lambda: lzy.workflow("inner").__enter__())


def _aborted_workflow(ns):
    log = []

    @ns.op
    def record(x: int) -> int:
        log.append(x)
        return x

    try:
        with _lzy(ns).workflow("wf"):
            record(1)
            raise RuntimeError("user code")
    except RuntimeError as e:
        return [str(e), log]


def _caching(ns):
    """test_workflow_local.py's TestCaching: repeated runs, a version
    bump, other inputs, kwarg names, lineage through a non-cached
    producer, chained cached ops."""
    lzy = _lzy(ns)
    runs = []

    def heavy_op(version):
        @ns.op(cache=True, version=version)
        def heavy(x: int = 0, y: int = 0) -> int:
            runs.append(("heavy", version, x, y))
            return x * 10 - y

        return heavy

    @ns.op
    def produce(n: int) -> int:
        runs.append(("produce", n))
        return n + 1

    @ns.op(cache=True, version="1.0")
    def consume(x: int) -> int:
        runs.append(("consume", x))
        return x * 2

    out = []
    for version, kwargs in (("1.0", dict(x=4)), ("1.0", dict(x=4)),
                            ("2.0", dict(x=4)), ("2.0", dict(x=5)),
                            ("2.0", dict(y=5))):
        with lzy.workflow("wf"):
            out.append(heavy_op(version)(**kwargs) + 0)
    for _ in range(2):
        with lzy.workflow("wf"):
            out.append(consume(produce(1)) + 0)
            out.append(consume(consume(3)) + 0)
    return [out, runs]


def _whiteboards(ns):
    lzy = _lzy(ns)

    @ns.whiteboard("best_model")
    @dataclasses.dataclass
    class Best:
        score: float
        params: dict

    @ns.whiteboard("partial_wb")
    @dataclasses.dataclass
    class Partial:
        x: int
        y: int

    @ns.op
    def train(seed: int) -> dict:
        return {"w": seed * 1.5}

    for i, tags in enumerate([["a"], ["a", "b"]]):
        with lzy.workflow("wf") as wf:
            wb = wf.create_whiteboard(Best, tags=tags)
            wb.params = train(i)       # a proxy: copied at exit
            wb.score = 0.5 + i         # a local value: uploaded now
            wb_id = wb.id
    one = lzy.whiteboard(id_=wb_id)
    seen = [one.name, one.score, one.params, sorted(one.tags)]
    seen.append(len(lzy.whiteboards(name="best_model")))
    seen.append([w.score for w in lzy.whiteboards(name="best_model",
                                                   tags=["b"])])
    seen.append([w.score for w in lzy.whiteboards(tags=["a"])])
    seen.append(lzy.whiteboards(name="missing"))

    def unassigned():
        with lzy.workflow("wf") as wf:
            wf.create_whiteboard(Partial).x = 1

    def not_a_whiteboard():
        with lzy.workflow("wf") as wf:
            wf.create_whiteboard(dict)

    seen += [_raised(unassigned)[0], _raised(not_a_whiteboard)[0]]
    return seen


def _unknown_storage_scheme(ns):
    return _raised(lambda: _storage(ns, uri="ftp://nowhere/x"))


def _never_written_entry(ns):
    with _lzy(ns).workflow("wf") as wf:
        typed = wf.snapshot.create_entry("typed", int)
        untyped = wf.snapshot.create_entry("untyped")
        return [_raised(lambda: wf.snapshot.get(typed.id))[0],
                _raised(lambda: wf.snapshot.get(untyped.id))[0],
                wf.snapshot.try_restore_entry(typed.id)]


SDK_CASES = {
    "proxies and laziness": _proxies_and_laziness,
    "chained and multi-output ops": _chained_and_multi_output,
    "barrier on exit": _barrier_on_exit,
    "op exception re-raised": _op_exception,
    "argument type validation": _type_validation,
    "bool and None results eager": _bool_and_none_eager,
    "env vars applied and restored": _env_vars,
    "Optional annotations": _optional_annotations,
    "failed exit barrier aborts": _failed_exit_barrier_aborts,
    "lazy_arguments=False": _lazy_arguments_false,
    "nested workflow refused": _nested_workflow,
    "aborted workflow skips its queue": _aborted_workflow,
    "caching": _caching,
    "whiteboards": _whiteboards,
    "unknown storage scheme": _unknown_storage_scheme,
    "never-written entry": _never_written_entry,
}


def _port_only_cases(monkeypatch):
    """What the port does differently, by design."""
    ref, port = _packages()
    fails = []
    # @op(tpu=...): an unported builder option is an unknown keyword
    if type(ref.op(tpu="v5e-16")(lambda: 1)).__name__ != "LzyOp":
        fails.append("the reference did not take @op(tpu=...)")
    got = _raised(lambda: port.op(tpu="v5e-16"))
    if got[0] != "TypeError" or "tpu" not in got[1]:
        fails.append(f"port @op(tpu=...): {got}, not a TypeError")
    # the reference's options that nothing in the port calls yet are
    # unknown there too: TypeError for a keyword, AttributeError for a method
    unported = {
        "@op(description=)": lambda ns: ns.op(description="d")(lambda: 1),
        "@op(output_types=)": lambda ns: ns.op(output_types=[int])(lambda: 1),
        "workflow(eager=)": lambda ns: _lzy(ns).workflow("w", eager=True),
        "whiteboards(not_before=, not_after=)": lambda ns: _lzy(ns).whiteboards(
            name="x", not_before=None, not_after=None),
        "whiteboard(storage_uri=)": lambda ns: _lzy(ns).whiteboard(
            storage_uri="mem://nowhere/wb"),
        "register(priority=)": lambda ns: _lzy(ns).serializer_registry.register(
            _lzy(ns).serializer_registry.find_by_format("primitive"),
            priority=0),
        "unregister()": lambda ns: _lzy(ns).serializer_registry.unregister(
            "primitive"),
    }
    for label, call in unported.items():
        r, p = _raised(lambda: call(ref)), _raised(lambda: call(port))
        if r[0] in ("TypeError", "AttributeError"):
            fails.append(f"the reference did not take {label}: {r}")
        if p[0] not in ("TypeError", "AttributeError"):
            fails.append(f"port {label}: {p}, not refused")
    # lzy_auth writes the reference's variables (restored by monkeypatch)
    keys = ("LZY_USER", "LZY_KEY_PATH", "LZY_ENDPOINT",
            "LZY_WHITEBOARD_ENDPOINT")
    seen = {}
    for ns in (ref, port):
        for k in keys:
            monkeypatch.setenv(k, "unset")
        ns.lzy_auth(user="u", key_path="/k", endpoint="e:1",
                    whiteboards_endpoint="w:2")
        seen[ns.name] = [os.environ[k] for k in keys]
    if seen["reference"] != seen["port"]:
        fails.append(f"lzy_auth: {seen}")
    # the default storage roots differ (no I/O: only the configs)
    monkeypatch.delenv("LZY_TPU_LOCAL_STORAGE", raising=False)
    monkeypatch.delenv("LZY_TPU_TORCH_LOCAL_STORAGE", raising=False)
    roots = [ns.Lzy().storage_registry.default_config().uri
             for ns in (ref, port)]
    if roots[0] == roots[1] or not roots[1].endswith("lzy_tpu_torch_storage"):
        fails.append(f"default storage roots: {roots}")
    return fails


def test_workflow_slice_and_sdk_semantics_match_reference(monkeypatch):
    ref, port = _packages()
    fails = [f"slice: {f}" for f in _slice_case()]
    for name, case in SDK_CASES.items():
        got = {}
        for ns in (ref, port):
            try:
                got[ns.name] = case(ns)
            except Exception as e:  # noqa: BLE001 — reported per case
                got[ns.name] = f"raised {type(e).__name__}: {e}"
        if got["reference"] != got["port"]:
            fails.append(f"{name}: reference {got['reference']!r}, port "
                         f"{got['port']!r}")
    fails += _port_only_cases(monkeypatch)
    assert not fails, "\n".join(fails)
