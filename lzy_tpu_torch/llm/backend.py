"""Serving-plane resolution for the ``llm`` op surface: the port's copy of
``lzy_tpu/llm/backend.py``.

An ``llm.generate`` op body runs wherever the runtime puts it (the
user's thread under ``LocalRuntime``, a worker thread under the
in-process cluster) and needs a serving plane to dispatch to. A backend
is that handle: anything with the gateway's ``generate`` surface (a
``GatewayService``, a ``DisaggGatewayService``) or a raw engine, wrapped
with what the op layer also needs:

a **model digest**, part of the op cache key: a cached generation is
invalidated when the served model changes.

Resolution: the process-global backend set by :func:`configure`. The
reference's second route, ``LZY_LLM_ENDPOINT`` (an RPC client dialing a
remote plane), waits for the RPC serving plane; here it raises
:class:`LlmBackendError` naming what is missing. So do the reference's
bearer tokens (``ServiceBackend(token=)``, ``configure(token=)``),
which wait for IAM.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Optional


class LlmBackendError(RuntimeError):
    """No serving plane is reachable from this process."""


def model_digest_for(model_name: str, cfg: Any = None,
                     checkpoint: Optional[str] = None,
                     seed: Optional[int] = None) -> str:
    """Deterministic digest of what a plane serves: model name, config
    fields and weight provenance (checkpoint path, init seed). The
    weights themselves are not hashed."""
    doc = {"model": model_name, "checkpoint": checkpoint, "seed": seed}
    if cfg is not None:
        fields = getattr(cfg, "__dict__", None) or {}
        doc["cfg"] = {k: repr(v) for k, v in sorted(fields.items())
                      if not k.startswith("_")}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode("utf-8")).hexdigest()[:16]


def _is_signature_mismatch(e: TypeError) -> bool:
    """CPython's wording for a keyword the callee does not accept: the
    one ``TypeError`` the degradation ladder may swallow."""
    msg = str(e)
    return ("unexpected keyword argument" in msg
            or "takes no keyword arguments" in msg)


class ServiceBackend:
    """Wrap anything speaking the gateway's ``generate`` surface.

    ``digest`` overrides the model digest; otherwise the service's
    ``model_digest`` attribute (set by the build functions in
    ``service/inference.py``) is used, falling back to one derived from a
    live engine's config.
    """

    def __init__(self, service: Any, *, digest: Optional[str] = None):
        self.service = service
        self._digest = digest

    @property
    def model_name(self) -> str:
        return getattr(self.service, "model_name", "custom")

    def model_digest(self) -> str:
        if self._digest is None:
            self._digest = getattr(self.service, "model_digest", None) \
                or self._derive_digest()
        return self._digest

    def _derive_digest(self) -> str:
        cfg = None
        engine = getattr(self.service, "engine", None)
        if engine is not None:
            cfg = getattr(engine, "cfg", None)
        else:
            fleet = getattr(self.service, "fleet", None)
            if fleet is not None:
                for replica in fleet.replicas():
                    cfg = getattr(replica.engine, "cfg", None)
                    if cfg is not None:
                        break
        return model_digest_for(self.model_name, cfg)

    def generate(self, prompt, **kwargs) -> dict:
        # None-valued extension keywords go up front: a surface that
        # takes ``session`` but not ``stream`` must still get the session
        for opt in ("session", "stream"):
            if kwargs.get(opt) is None:
                kwargs.pop(opt, None)
        stream = kwargs.get("stream")
        # an older surface degrades one extension at a time: the stream
        # first (the terminal flush below keeps it whole), then the
        # session (a routing hint: a stale one costs a prefill, never a
        # wrong token)
        attempts = [kwargs]
        for drop in (("stream",), ("stream", "session")):
            trimmed = {k: v for k, v in kwargs.items() if k not in drop}
            if trimmed != attempts[-1]:
                attempts.append(trimmed)
        reply = kw = None
        for i, kw in enumerate(attempts):
            try:
                reply = self.service.generate(prompt, **kw)
                break
            except TypeError as e:
                # only a SIGNATURE mismatch degrades; a TypeError from
                # inside the surface must surface, not re-dispatch
                if i == len(attempts) - 1 or \
                        not _is_signature_mismatch(e):
                    raise
        if stream is not None and "stream" not in kw:
            try:
                stream.publish(0, reply.get("tokens", []))
                stream.close(reply.get("status", "ok"))
            except Exception:  # noqa: BLE001 — the reply owns the data
                pass
        return reply


class EngineBackend:
    """Wrap a raw in-process engine for ``LocalRuntime`` dev loops: no
    gateway and no routing metadata; ``submit`` and a wait shaped into
    the reply dict the op layer reads."""

    def __init__(self, engine: Any, *, model_name: str = "custom",
                 digest: Optional[str] = None):
        self.engine = engine
        self.model_name = model_name
        self._digest = digest

    def model_digest(self) -> str:
        if self._digest is None:
            self._digest = model_digest_for(
                self.model_name, getattr(self.engine, "cfg", None))
        return self._digest

    def generate(self, prompt, *, max_new_tokens: int = 64,
                 timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 greedy: Optional[bool] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 session: Optional[str] = None,
                 stream=None) -> dict:
        from lzy_tpu_torch.channels.token_stream import (
            attach_request, fail_if_touched)

        req = self.engine.submit(
            prompt, max_new_tokens=int(max_new_tokens),
            deadline_s=deadline_s, greedy=greedy,
            tenant=tenant or "default", priority=priority)
        if stream is not None:
            attach_request(stream, req, 0)
        try:
            if not req.wait(timeout=timeout_s or 120.0):
                req.cancel()
                raise TimeoutError(
                    f"request {req.id} not finished within "
                    f"{timeout_s or 120.0}s")
            if req.error and req.status != "cancelled":
                raise RuntimeError(
                    f"request {req.id} failed: {req.error}")
        except BaseException as e:
            fail_if_touched(stream, e)
            raise
        if stream is not None:
            stream.close(req.status or "ok")
        ttft_ms = None
        if req.first_token_at is not None:
            ttft_ms = round(1000 * (req.first_token_at
                                    - req.submitted_at), 3)
        return {"request_id": req.id, "tokens": list(req.tokens),
                "status": req.status or "ok", "ttft_ms": ttft_ms,
                "model": self.model_name}


_lock = threading.Lock()
_configured: Optional[Any] = None


def configure(backend: Any) -> Any:
    """Set the process-global serving backend the ``llm`` op surface
    dispatches to: a ready :class:`ServiceBackend` or
    :class:`EngineBackend`, or a service with the gateway's ``generate``
    surface (wrapped in a :class:`ServiceBackend`). Returns the installed
    backend; ``configure(None)`` clears it. Either way the workflow
    scheduler of the old backend is closed (its threads joined)."""
    global _configured
    if backend is not None and \
            not callable(getattr(backend, "model_digest", None)):
        # a service object (its model_digest, if any, is a plain string
        # the build functions attach): wrap it
        backend = ServiceBackend(backend)
    with _lock:
        _configured = backend
    from lzy_tpu_torch.llm import sched

    sched.reset()
    return backend


def resolve_backend() -> Any:
    """The backend an op body dispatches to. Raises
    :class:`LlmBackendError` when none is configured."""
    with _lock:
        if _configured is not None:
            return _configured
    if os.environ.get("LZY_LLM_ENDPOINT"):
        raise LlmBackendError(
            "LZY_LLM_ENDPOINT is set, but the port has no RPC inference "
            "client (RpcInferenceClient) yet: call "
            "lzy_tpu_torch.llm.configure(<service>) in this process")
    raise LlmBackendError(
        "no llm serving backend: call lzy_tpu_torch.llm.configure("
        "<service>) in this process")
