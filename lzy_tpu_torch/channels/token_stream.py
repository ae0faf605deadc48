"""Token-streaming channels: incremental token delivery from engine to
consumer. The port's copy of ``lzy_tpu/channels/token_stream.py``.

A :class:`TokenStreamChannel` is the rendezvous for one generation: the
serving side publishes tokens *by position* as the engine emits them,
consumers block on :meth:`~TokenStreamChannel.read` (or iterate) and see
each token once, in order.

The position is the **fence**. The gateway's mid-stream failover fences
emitted tokens (retry prompt = prompt + emitted); the stream producer
keeps publishing at the fence position after the retry, so a replica
death is invisible to the consumer except for ``resumptions`` ticking
up. :meth:`~TokenStreamChannel.publish` is idempotent and verifying: a
position already present must carry the same token, and a mismatch
raises :class:`StreamSpliceError` instead of splicing a divergent
continuation.

Transports:

- **in-process**: producer and consumer share the channel object, found
  through the process-global :data:`STREAMS` registry when only an id
  can travel (op arguments are serialized; live channels are not);
- **storage spill**: :class:`StorageTokenStreamWriter` appends chunk
  objects under a URI prefix and writes a terminal manifest LAST;
  :class:`StorageTokenStreamReader` reads chunks and finishes on the
  manifest.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from lzy_tpu_torch.storage.api import join_uri
from lzy_tpu_torch.utils.ids import gen_id


class StreamSpliceError(RuntimeError):
    """A publish disagreed with tokens already in the stream: the fence
    was violated."""


class StreamFailed(RuntimeError):
    """The producer failed the stream; consumers see the error instead of
    blocking forever."""


class TokenStreamChannel:
    """One generation's token stream; thread-safe.

    Producers call :meth:`publish` with an absolute position; consumers
    call :meth:`read` or iterate. Terminal states: :meth:`close` (with the
    request's terminal status, ``ok`` or ``cancelled``) or :meth:`fail`.
    """

    def __init__(self, channel_id: Optional[str] = None):
        self.id = channel_id or gen_id("tokstream")
        self._tokens: List[int] = []
        self._cv = threading.Condition()
        self._closed = False
        self._status: Optional[str] = None
        self._error: Optional[str] = None
        self._resumptions = 0
        #: the highest position a consumer has acknowledged
        self._acked = 0

    # -- producer side -------------------------------------------------------

    def publish(self, position: int, tokens: Sequence[int]) -> None:
        """Idempotent positioned append: positions already present are
        verified against the stream, only the new suffix is appended. A
        gap or a mismatch raises :class:`StreamSpliceError`."""
        toks = [int(t) for t in tokens]
        with self._cv:
            if self._closed:
                # a late duplicate of an already-complete prefix is benign
                if position + len(toks) <= len(self._tokens) and \
                        self._tokens[position:position + len(toks)] == toks:
                    return
                raise StreamSpliceError(
                    f"stream {self.id} already closed at position "
                    f"{len(self._tokens)}; refusing publish at {position}")
            if position > len(self._tokens):
                raise StreamSpliceError(
                    f"stream {self.id} publish at {position} leaves a gap "
                    f"(stream is at {len(self._tokens)})")
            overlap = len(self._tokens) - position
            if toks[:overlap] != self._tokens[position:]:
                raise StreamSpliceError(
                    f"stream {self.id} publish at {position} diverges from "
                    f"the fenced prefix")
            new = toks[overlap:]
            if new:
                self._tokens.extend(new)
                self._cv.notify_all()

    def note_resumption(self) -> None:
        """The producer failed over mid-stream and resumes at the fence."""
        with self._cv:
            self._resumptions += 1
        from lzy_tpu_torch.llm.metrics import STREAM_RESUMPTIONS

        STREAM_RESUMPTIONS.inc()

    def close(self, status: str = "ok") -> None:
        """Terminal: no more tokens. Idempotent (keeps the first status)."""
        with self._cv:
            if not self._closed:
                self._closed = True
                self._status = status
            self._cv.notify_all()

    def fail(self, error: str) -> None:
        with self._cv:
            if not self._closed:
                self._closed = True
                self._status = "error"
                self._error = error
            self._cv.notify_all()

    # -- consumer side -------------------------------------------------------

    @property
    def position(self) -> int:
        with self._cv:
            return len(self._tokens)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    @property
    def status(self) -> Optional[str]:
        with self._cv:
            return self._status

    @property
    def error(self) -> Optional[str]:
        with self._cv:
            return self._error

    @property
    def resumptions(self) -> int:
        with self._cv:
            return self._resumptions

    @property
    def acked(self) -> int:
        with self._cv:
            return self._acked

    def ack(self, position: int) -> None:
        """Record consumer progress up to ``position`` (monotonic)."""
        with self._cv:
            self._acked = min(max(self._acked, int(position)),
                              len(self._tokens))

    def tokens(self) -> List[int]:
        """Snapshot of everything published so far."""
        with self._cv:
            return list(self._tokens)

    def read(self, start: int = 0,
             timeout_s: Optional[float] = None) -> List[int]:
        """Block until the stream moves past ``start`` (or terminates);
        returns ``tokens[start:]``. Empty means the stream closed with
        nothing after ``start``. Raises :class:`StreamFailed` on a failed
        stream, ``TimeoutError`` on timeout."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cv:
            while len(self._tokens) <= start and not self._closed:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"stream {self.id} produced nothing past "
                        f"{start} within {timeout_s}s")
                self._cv.wait(1.0 if remaining is None else remaining)
            if self._error is not None:
                raise StreamFailed(f"stream {self.id} failed: {self._error}")
            out = list(self._tokens[start:])
            self._acked = max(self._acked, start + len(out))
            return out

    def __iter__(self) -> Iterator[int]:
        """Yield tokens one at a time as they arrive, until the stream
        terminates. Raises :class:`StreamFailed` if it failed."""
        pos = 0
        while True:
            with self._cv:
                while len(self._tokens) <= pos and not self._closed:
                    self._cv.wait(1.0)
                if len(self._tokens) > pos:
                    tok = self._tokens[pos]
                    self._acked = max(self._acked, pos + 1)
                else:
                    if self._error is not None:
                        raise StreamFailed(
                            f"stream {self.id} failed: {self._error}")
                    return
            pos += 1
            yield tok


def fail_if_touched(stream: Optional[TokenStreamChannel],
                    exc: BaseException) -> None:
    """The serving surfaces' failure rule: fail the channel only if this
    attempt published into it. A virgin (zero-token) stream stays OPEN:
    the caller got the exception and owns the retry-or-fail decision.
    Never raises."""
    if stream is None:
        return
    try:
        if stream.position:
            stream.fail(f"{type(exc).__name__}: {exc}")
    except Exception:  # noqa: BLE001 — the reply owns the error
        pass


def attach_request(channel: TokenStreamChannel, req, base: int) -> Callable:
    """Wire a serving request to a channel: every token the engine emits
    for ``req`` is published at ``base + <index within this attempt>``.
    ``base`` is the fence, the count of tokens streamed by earlier
    attempts of the same logical request. Tokens emitted before the
    attach are flushed at once; publishing is idempotent, so the engine
    thread and the attaching thread may race harmlessly. The engine calls
    the returned sink through ``req.token_sink`` after each emission."""
    state = {"sent": 0}

    def sink(r=req) -> None:
        toks = r.tokens
        n = len(toks)
        sent = state["sent"]
        if n > sent:
            channel.publish(base + sent, [int(t) for t in toks[sent:n]])
            state["sent"] = n

    req.token_sink = sink
    sink()           # flush anything emitted before the attach
    return sink


class TokenStreamRegistry:
    """Process-global id -> channel rendezvous (the in-process
    transport). Entries are released explicitly, or the oldest go first
    past :attr:`CAP`."""

    CAP = 4096

    def __init__(self):
        self._channels: Dict[str, TokenStreamChannel] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    def _add_locked(self, channel: TokenStreamChannel) -> None:
        self._channels[channel.id] = channel
        self._order.append(channel.id)
        while len(self._order) > self.CAP:
            self._channels.pop(self._order.pop(0), None)

    def get_or_create(self, channel_id: str) -> TokenStreamChannel:
        with self._lock:
            ch = self._channels.get(channel_id)
            if ch is None:
                ch = TokenStreamChannel(channel_id)
                self._add_locked(ch)
            return ch

    def register(self, channel: TokenStreamChannel) -> str:
        with self._lock:
            if channel.id not in self._channels:
                self._add_locked(channel)
            return channel.id

    def get(self, channel_id: str) -> Optional[TokenStreamChannel]:
        with self._lock:
            return self._channels.get(channel_id)

    def release(self, channel_id: str) -> None:
        with self._lock:
            self._channels.pop(channel_id, None)
            try:
                self._order.remove(channel_id)
            except ValueError:
                pass


#: the process-global registry
STREAMS = TokenStreamRegistry()


# -- storage-spill fallback ---------------------------------------------------

class StorageTokenStreamWriter:
    """Chunked durable mirror of a token stream: ``chunk-<n>.json``
    objects of at most ``chunk_tokens`` tokens each, then a terminal
    ``manifest.json`` written LAST, so a reader that sees the manifest
    has every chunk below it."""

    def __init__(self, client, uri: str, *, chunk_tokens: int = 64):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got "
                             f"{chunk_tokens}")
        self._client = client
        self._uri = uri
        self._chunk_tokens = chunk_tokens
        self._written = 0
        self._chunks = 0
        self._pending: List[int] = []
        self._done = False

    def append(self, tokens: Sequence[int]) -> None:
        if self._done:
            raise RuntimeError("stream writer already finished")
        self._pending.extend(int(t) for t in tokens)
        while len(self._pending) >= self._chunk_tokens:
            self._flush_chunk(self._pending[:self._chunk_tokens])
            self._pending = self._pending[self._chunk_tokens:]

    def _flush_chunk(self, toks: List[int]) -> None:
        uri = join_uri(self._uri, f"chunk-{self._chunks:06d}.json")
        self._client.write_bytes(uri, json.dumps(toks).encode("utf-8"))
        self._chunks += 1
        self._written += len(toks)

    def finish(self, status: str = "ok",
               error: Optional[str] = None) -> None:
        """Flush the tail chunk and commit the manifest (idempotent)."""
        if self._done:
            return
        if self._pending:
            self._flush_chunk(self._pending)
            self._pending = []
        manifest = {"status": status, "error": error,
                    "chunks": self._chunks, "tokens": self._written,
                    "chunk_tokens": self._chunk_tokens}
        self._client.write_bytes(
            join_uri(self._uri, "manifest.json"),
            json.dumps(manifest).encode("utf-8"))
        self._done = True


class StorageTokenStreamReader:
    """Polling consumer of a spilled stream: reads chunk objects as they
    appear (every :attr:`POLL_S`) and finishes when the manifest lands."""

    POLL_S = 0.02

    def __init__(self, client, uri: str):
        self._client = client
        self._uri = uri

    def _manifest(self) -> Optional[dict]:
        uri = join_uri(self._uri, "manifest.json")
        if not self._client.exists(uri):
            return None
        return json.loads(self._client.read_bytes(uri))

    def _failed(self, manifest: dict) -> StreamFailed:
        return StreamFailed(f"spilled stream at {self._uri} failed: "
                            f"{manifest.get('error')}")

    def read_all(self, timeout_s: float = 120.0) -> dict:
        """Block until the manifest commits; returns ``{"tokens",
        "status", "error"}``. Raises :class:`StreamFailed` for a failed
        stream, ``TimeoutError`` past the budget."""
        deadline = time.monotonic() + timeout_s
        while True:
            manifest = self._manifest()
            if manifest is not None:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"spilled stream at {self._uri} not finished within "
                    f"{timeout_s}s")
            time.sleep(self.POLL_S)
        tokens: List[int] = []
        for n in range(manifest["chunks"]):
            uri = join_uri(self._uri, f"chunk-{n:06d}.json")
            tokens.extend(json.loads(self._client.read_bytes(uri)))
        if manifest["status"] == "error":
            raise self._failed(manifest)
        return {"tokens": tokens, "status": manifest["status"],
                "error": manifest.get("error")}

    def iter_tokens(self, timeout_s: float = 120.0) -> Iterator[int]:
        """Incremental read: yield chunk contents as chunks appear;
        return once the manifest commits and every chunk is drained."""
        deadline = time.monotonic() + timeout_s
        next_chunk = 0
        while True:
            uri = join_uri(self._uri, f"chunk-{next_chunk:06d}.json")
            if self._client.exists(uri):
                yield from json.loads(self._client.read_bytes(uri))
                next_chunk += 1
                continue
            manifest = self._manifest()
            if manifest is not None and next_chunk >= manifest["chunks"]:
                if manifest["status"] == "error":
                    raise self._failed(manifest)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"spilled stream at {self._uri} stalled at chunk "
                    f"{next_chunk} for {timeout_s}s")
            time.sleep(self.POLL_S)
