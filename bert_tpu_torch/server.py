"""Embedding server: reference-wire-compatible TCP front-end with a
continuous-batching scheduler.

Counterpart of ``bert_tpu/server.py`` (a copy: the port imports nothing of
bert_tpu), serving a :class:`~bert_tpu_torch.BertTorch`. The wire is
byte-compatible with the reference server (examples/server.cpp:26-34,107)
and with bert_tpu's, so examples/socket_client.py and ``csrc/libbert.so``
in host:port mode work unchanged:

  * on connect, the server sends ``n_embd`` as a raw little-endian int32;
  * a client sends one UTF-8 text per message (single read, ≤ 32 KiB, no
    length framing — a documented reference quirk);
  * the server replies with ``n_embd`` raw little-endian float32s.

Framed messages extend it (below). Every connection feeds a shared queue,
and a micro-batching scheduler drains it into batches for the engine,
which routes them into packed rows and length buckets on the card. The
default window policy is **adaptive** (work-conserving continuous
batching): a request dispatches at once when the device slot is free, and
while it is busy the forming batch absorbs every queued arrival (up to
``max_batch``). A numeric ``batch_window_ms`` gives a fixed window.
``BERT_TPU_SCHED_TRACE=path.jsonl`` appends one JSON line per dispatched
batch with its collect / slot / eval timeline, as bert_tpu's does.

On a mesh (``--dp``/``--tp``, one process per rank under torchrun) rank 0
owns the socket and the scheduler: before it runs a batch it broadcasts
the batch's token lists, and every other rank runs the same engine call
in :func:`follow` until rank 0 broadcasts the stop.

    python -m bert_tpu_torch.server -m <model> [--device cpu] [--port P]
    torchrun --nproc-per-node N -m bert_tpu_torch.server -m <model> \\
        --dp D --tp T                      # D·T = N ranks
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import math
import os
import signal
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

MAX_MSG = 1 << 15  # reference read buffer size (server.cpp:27)

# Framed messages (csrc/bert_client.cpp backs the C API with them). Every
# magic starts with 0xB5 — an invalid UTF-8 lead-in position — so no real
# text message can collide with one. All integers are little-endian.
#
#   EVAL   magic, i32 n_tokens, n_tokens × i32 ids
#          → n_embd raw f32 (same reply shape as a text message)
#   BATCH  magic, i32 n_sentences, then per sentence i32 n_tokens + ids
#          → n_sentences × n_embd raw f32, in request order (one round
#            trip for the whole batch)
#   META   magic only → magic echo, i32 version, i32 n_embd,
#          i32 n_max_tokens (16 bytes)
#   STATS  magic only → magic echo, u64 n_served, u64 n_batches (20 bytes)
#   STATS2 magic only → magic echo, u64 n_served, u64 n_batches,
#          u32 latency sample count, u32 p50, u32 p95, u32 p99 (µs,
#          request submit→result over a sliding reservoir; 36 bytes)
BIN_EVAL_MAGIC = b"\xb5\x87\xe3\x01"
BIN_BATCH_MAGIC = b"\xb5\x87\xe3\x02"
BIN_META_MAGIC = b"\xb5\x87\xe3\x03"
BIN_STATS_MAGIC = b"\xb5\x87\xe3\x04"
BIN_STATS2_MAGIC = b"\xb5\x87\xe3\x05"
PROTOCOL_VERSION = 1
MAX_BATCH_SENTENCES = 16384  # caps a framed batch reply at ~25 MB (D=384)

Payload = Union[str, List[int]]


class BatchingScheduler:
    """Collects (payload, future) requests and evaluates them in
    micro-batches."""

    def __init__(self, model, *, max_batch: int = 64,
                 batch_window_ms: Union[float, str] = "adaptive",
                 pipeline_depth: int = 1,
                 queue_depth: Optional[int] = None):
        self.model = model
        self.max_batch = max_batch
        # "adaptive": while every device slot is busy, waiting costs
        # nothing, so the forming batch absorbs queued arrivals. When a
        # slot frees with the batch under-full, closed-loop clients whose
        # results were just delivered are about to resubmit; once a step
        # time has been measured and arrivals have shown concurrency (a
        # lone client never waits), the dispatcher holds the free slot for
        # at most a fraction of one step and leaves at the first empty gap.
        self.adaptive = batch_window_ms == "adaptive"
        self.batch_window = (0.0 if self.adaptive
                             else float(batch_window_ms) / 1000.0)
        self._step_ema: Optional[float] = None  # EMA of batch eval seconds
        # EMA of the concurrency indicator: 1.0 when a batch carried ≥2
        # requests or its first request arrived while a slot was busy.
        # Starts at 0 so the first requests ever seen are never held.
        self._conc_ema: float = 0.0
        self.patience_frac = 0.25   # of one step
        self.patience_cap = 0.020   # seconds
        self.gap_cap = 0.002        # one empty gap ends the hold
        self._evals_inflight = 0
        self._first_while_busy = False
        # bounded queue = backpressure: submit() suspends its connection
        # handler once ~128 micro-batches are pending; an explicit 0 keeps
        # asyncio's meaning (unbounded)
        self.queue_depth = (queue_depth if queue_depth is not None
                            else max_batch * 128)
        # micro-batches in flight at once (>1 overlaps one batch's host work
        # with the previous batch's device work)
        self.pipeline_depth = max(1, pipeline_depth)
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=self.queue_depth)
        self._task: Optional[asyncio.Task] = None
        # strong refs to in-flight eval tasks (the loop keeps weak ones)
        self._inflight: set = set()
        self.n_served = 0
        self.n_batches = 0
        # sliding reservoir of request latencies (submit → result, s)
        self.latencies: deque = deque(maxlen=4096)
        # per-batch scheduler trace (BERT_TPU_SCHED_TRACE=path.jsonl): one
        # JSON line per dispatched batch with its timeline, monotonic s
        trace_path = os.environ.get("BERT_TPU_SCHED_TRACE")
        self._trace = open(trace_path, "a") if trace_path else None
        self._last_collect: dict = {}

    async def _enqueue(self, payload: Payload, t_submit: float):
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        fut._t_submit = t_submit
        await self.queue.put((payload, fut))
        return fut

    async def submit(self, text: str) -> np.ndarray:
        return await (await self._enqueue(text, time.monotonic()))

    async def submit_tokens(self, token_ids: Sequence[int]) -> np.ndarray:
        """Pre-tokenized request (framed EVAL / C API bert_eval)."""
        return await (await self._enqueue(list(token_ids), time.monotonic()))

    async def submit_many(self, payloads: Sequence[Payload]
                          ) -> List[np.ndarray]:
        """Enqueue a whole framed batch at once; results in request order.
        Every sibling future is retrieved even when one micro-batch fails,
        and the first failure is re-raised."""
        t0 = time.monotonic()
        futs = [await self._enqueue(p, t0) for p in payloads]
        results = await asyncio.gather(*futs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    def latency_percentiles_us(self):
        """(n, p50, p95, p99) in µs over the reservoir (zeros when empty).
        Ceil rank, so a small reservoir's tail rounds to the worse sample;
        clamped to the wire's u32."""
        if not self.latencies:
            return 0, 0, 0, 0
        s = np.sort(np.asarray(self.latencies))

        def pick(q):
            i = min(len(s) - 1, math.ceil(q * (len(s) - 1)))
            return min(0xFFFFFFFF, int(s[i] * 1e6))
        return len(s), pick(0.50), pick(0.95), pick(0.99)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        for task in (self._task, *tuple(self._inflight)):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # fail queued-but-never-collected requests: the collector is dead
        while True:
            try:
                _, fut = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.set_exception(ConnectionError("server shutting down"))
        if self._trace is not None:
            self._trace.close()
            self._trace = None

    def _drain_into(self, batch: list) -> None:
        while len(batch) < self.max_batch:
            try:
                batch.append(self.queue.get_nowait())
            except asyncio.QueueEmpty:
                break

    async def _collect(self, batch: List[Tuple[Payload, asyncio.Future]]
                       ) -> None:
        """Collect the next micro-batch by APPENDING into ``batch`` (owned
        by _run), so requests dequeued before a cancellation can still be
        failed there."""
        batch.append(await self.queue.get())
        # a lone closed-loop client's next request cannot exist while its
        # previous one is still evaluating
        self._first_while_busy = self._evals_inflight > 0
        if self._trace is not None:
            self._last_collect = {"t_first": time.monotonic()}
        if self.adaptive:
            self._drain_into(batch)  # the slot wait in _run batches more
            return
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self.queue.get(),
                                                    timeout))
            except asyncio.TimeoutError:
                break

    def _adaptive_patience(self) -> float:
        """How long an under-full batch may hold a free slot: zero until a
        step time is known and while requests arrive alone; else a fraction
        of one step, capped."""
        if self._step_ema is None or self._conc_ema < 0.25:
            return 0.0
        return min(self.patience_frac * self._step_ema, self.patience_cap)

    def _eval_mixed(self, payloads: List[Payload]) -> np.ndarray:
        """Evaluate a batch that may mix raw texts and pre-tokenized ids."""
        toks: List[List[int]] = list(payloads)  # type: ignore[arg-type]
        text_idx = [i for i, p in enumerate(payloads) if isinstance(p, str)]
        if text_idx:
            # the engine's tokenize phase, where the engine keeps timers
            timers = getattr(self.model, "timers", None)
            with (timers.phase("tokenize") if timers is not None
                  else contextlib.nullcontext()):
                tokenized = self.model.tokenizer.tokenize_batch(
                    [payloads[i] for i in text_idx], self.model.n_max_tokens)
            for i, t in zip(text_idx, tokenized):
                toks[i] = t
        return self.model.eval_tokens(toks)

    async def _eval_one_batch(self, batch, sem: asyncio.Semaphore,
                              trace: Optional[dict] = None) -> None:
        loop = asyncio.get_running_loop()
        t_start = time.monotonic()
        try:
            # evaluation waits on the device → a worker thread, so the event
            # loop keeps accepting and collecting meanwhile
            embs = await loop.run_in_executor(
                None, self._eval_mixed, [p for p, _ in batch])
            t_done = time.monotonic()
            step = t_done - t_start
            self._step_ema = (step if self._step_ema is None
                              else 0.25 * step + 0.75 * self._step_ema)
            for (_, fut), emb in zip(batch, embs):
                if not fut.done():
                    fut.set_result(emb)
                    self.latencies.append(t_done - fut._t_submit)
            # count only successful batches: a failed one served nobody
            self.n_served += len(batch)
            self.n_batches += 1
            if self._trace is not None and trace is not None:
                trace.update({"t_eval0": t_start, "t_eval1": t_done,
                              "n": len(batch)})
                self._trace.write(json.dumps(trace) + "\n")
                self._trace.flush()
        except asyncio.CancelledError:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(ConnectionError("server shutting down"))
            raise
        except Exception as exc:  # pragma: no cover - defensive
            logger.exception("batch evaluation failed")
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
        finally:
            self._evals_inflight -= 1
            sem.release()

    async def _hold_for_wave(self, batch: list) -> None:
        """The slot is free, but clients whose results were just delivered
        are about to resubmit: give them ≤ patience to land, leaving at the
        first empty gap."""
        patience = self._adaptive_patience()
        if patience <= 0:
            return
        deadline = time.monotonic() + patience
        gap = min(0.25 * patience, self.gap_cap)
        while len(batch) < self.max_batch:
            timeout = min(gap, deadline - time.monotonic())
            if timeout <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self.queue.get(),
                                                    timeout))
            except asyncio.TimeoutError:
                break

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.pipeline_depth)
        batch: List[Tuple[Payload, asyncio.Future]] = []
        try:
            while True:
                batch = []
                await self._collect(batch)
                if self._trace is not None:
                    self._last_collect["t_collect"] = time.monotonic()
                    self._last_collect["n_collect"] = len(batch)
                await sem.acquire()
                if self._trace is not None:
                    self._last_collect["t_slot"] = time.monotonic()
                if self.adaptive:
                    # what queued while this batch waited for the slot rides
                    # along at no added latency
                    self._drain_into(batch)
                    if len(batch) < self.max_batch:
                        await self._hold_for_wave(batch)
                    conc = 1.0 if (len(batch) >= 2
                                   or self._first_while_busy) else 0.0
                    self._conc_ema = 0.25 * conc + 0.75 * self._conc_ema
                self._evals_inflight += 1
                task = loop.create_task(self._eval_one_batch(
                    batch, sem, trace=self._last_collect or None))
                self._last_collect = {}
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
        except asyncio.CancelledError:
            # a collected-but-undispatched batch was already dequeued, so
            # stop()'s drain never sees it: fail it here
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        ConnectionError("server shutting down"))
            raise


class EmbeddingServer:
    def __init__(self, model, host: str = "0.0.0.0", port: int = 8085,
                 *, max_batch: int = 64,
                 batch_window_ms: Union[float, str] = "adaptive",
                 pipeline_depth: int = 1, queue_depth: Optional[int] = None):
        self.model = model
        self.host = host
        self.port = port
        self.scheduler = BatchingScheduler(
            model, max_batch=max_batch, batch_window_ms=batch_window_ms,
            pipeline_depth=pipeline_depth, queue_depth=queue_depth)
        self._server: Optional[asyncio.AbstractServer] = None

    @staticmethod
    async def _fill(reader: asyncio.StreamReader, buf: bytearray,
                    need: int) -> bool:
        """Grow ``buf`` to at least ``need`` bytes; False on EOF."""
        while len(buf) < need:
            more = await reader.read(need - len(buf))
            if not more:
                return False
            buf.extend(more)
        return True

    def _peek_n_tokens(self, buf: bytearray, off: int) -> int:
        """Read + validate the i32 token count at ``off``; raises
        ValueError."""
        (n_tok,) = struct.unpack_from("<i", buf, off)
        if not 0 <= n_tok <= self.model.n_max_tokens:
            raise ValueError(f"framed eval n_tokens={n_tok} out of range "
                             f"(max {self.model.n_max_tokens})")
        return n_tok

    def _read_token_list(self, buf: bytearray, off: int):
        """Parse one (i32 n_tokens, ids) record at ``off``; returns (ids,
        new_off) or raises ValueError on a bad count or an out-of-vocab id
        (an embedding gather must never see one). The caller guarantees the
        bytes are present."""
        n_tok = self._peek_n_tokens(buf, off)
        ids = np.frombuffer(bytes(buf[off + 4: off + 4 + 4 * n_tok]),
                            dtype="<i4")
        if n_tok and (ids.min() < 0 or ids.max() >= self.model.n_vocab):
            raise ValueError(
                f"framed eval token id out of range [0, "
                f"{self.model.n_vocab}): {int(ids.min())}..{int(ids.max())}")
        return ids.tolist(), off + 4 + 4 * n_tok

    async def _reply(self, writer: asyncio.StreamWriter, data: bytes) -> None:
        writer.write(data)
        await writer.drain()

    async def _handle_framed(self, magic: bytes,
                             reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             buf: bytearray) -> bool:
        """Process one framed message starting at buf[0]; consumes exactly
        its bytes (pipelined messages stay in ``buf``). Returns False when
        the connection must close (a malformed frame cannot be
        resynchronized)."""
        sched = self.scheduler
        if magic in (BIN_META_MAGIC, BIN_STATS_MAGIC, BIN_STATS2_MAGIC):
            del buf[:4]
            if magic == BIN_META_MAGIC:
                body = struct.pack("<iii", PROTOCOL_VERSION,
                                   self.model.n_embd, self.model.n_max_tokens)
            elif magic == BIN_STATS_MAGIC:
                body = struct.pack("<QQ", sched.n_served, sched.n_batches)
            else:
                body = struct.pack("<QQIIII", sched.n_served,
                                   sched.n_batches,
                                   *sched.latency_percentiles_us())
            await self._reply(writer, magic + body)
            return True
        if not await self._fill(reader, buf, 8):
            return False
        if magic == BIN_EVAL_MAGIC:
            try:
                n_tok = self._peek_n_tokens(buf, 4)
                if not await self._fill(reader, buf, 8 + 4 * n_tok):
                    return False
                ids, off = self._read_token_list(buf, 4)
            except ValueError as exc:
                logger.warning("rejecting framed eval: %s", exc)
                return False
            del buf[:off]
            emb = await sched.submit_tokens(ids)
            await self._reply(writer, np.asarray(emb, dtype="<f4").tobytes())
            return True
        # BIN_BATCH_MAGIC
        (n_sent,) = struct.unpack_from("<i", buf, 4)
        if not 1 <= n_sent <= MAX_BATCH_SENTENCES:
            logger.warning("rejecting framed batch with n_sentences=%d "
                           "(max %d)", n_sent, MAX_BATCH_SENTENCES)
            return False
        off = 8
        batches: List[List[int]] = []
        try:
            for _ in range(n_sent):
                if not await self._fill(reader, buf, off + 4):
                    return False
                n_tok = self._peek_n_tokens(buf, off)
                if not await self._fill(reader, buf, off + 4 + 4 * n_tok):
                    return False
                ids, off = self._read_token_list(buf, off)
                batches.append(ids)
        except ValueError as exc:
            logger.warning("rejecting framed batch: %s", exc)
            return False
        del buf[:off]
        embs = await sched.submit_many(batches)
        await self._reply(writer, np.concatenate(
            [np.asarray(e, dtype="<f4") for e in embs]).tobytes())
        return True

    _FRAMED_MAGICS = (BIN_EVAL_MAGIC, BIN_BATCH_MAGIC, BIN_META_MAGIC,
                      BIN_STATS_MAGIC, BIN_STATS2_MAGIC)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        logger.info("client connected: %s", peer)
        # handshake: n_embd as int32 (server.cpp:107)
        await self._reply(writer, struct.pack("<i", self.model.n_embd))
        buf = bytearray()
        try:
            while True:
                if not buf:
                    data = await reader.read(MAX_MSG)
                    if not data:
                        break
                    buf.extend(data)
                # a leading 0xB5 starts a framed magic; finish reading it if
                # it straddled a TCP segment, but only briefly: a short
                # non-UTF-8 text from a legacy client must still get a reply
                if buf[0] == 0xB5 and len(buf) < 4:
                    try:
                        if not await asyncio.wait_for(
                                self._fill(reader, buf, 4), timeout=1.0):
                            return
                    except asyncio.TimeoutError:
                        pass
                if len(buf) >= 4 and bytes(buf[:4]) in self._FRAMED_MAGICS:
                    if not await self._handle_framed(bytes(buf[:4]), reader,
                                                     writer, buf):
                        return
                    continue
                text = bytes(buf).decode("utf-8", errors="replace")
                buf.clear()
                emb = await self.scheduler.submit(text)
                await self._reply(writer,
                                  np.asarray(emb, dtype="<f4").tobytes())
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        except Exception:  # eval failure: close THIS connection, log it
            logger.exception("closing connection %s after failed request",
                             peer)
        finally:
            writer.close()
            logger.info("client disconnected: %s", peer)

    async def serve(self, ready_event: Optional[asyncio.Event] = None
                    ) -> None:
        self.scheduler.start()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        addr = self._server.sockets[0].getsockname()
        logger.info("server running on %s:%s", *addr[:2])
        print(f"Server running on port {addr[1]}", flush=True)
        if ready_event is not None:
            ready_event.set()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        await self.scheduler.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


class ServerThread:
    """An :class:`EmbeddingServer` whose event loop runs on a background
    thread, for an application (or a check) that serves and does other
    work in one process::

        with ServerThread(model, port=0) as st:
            ...  # clients connect to 127.0.0.1:st.port

    Keyword arguments go to :class:`EmbeddingServer`."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 **server_kw):
        self.server = EmbeddingServer(model, host=host, port=port,
                                      **server_kw)
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="embedding-server")

    def _main(self) -> None:
        async def run():
            self._loop = asyncio.get_running_loop()
            ready = asyncio.Event()
            self._task = asyncio.ensure_future(self.server.serve(ready))
            waiter = asyncio.ensure_future(ready.wait())
            await asyncio.wait({self._task, waiter},
                               return_when=asyncio.FIRST_COMPLETED)
            waiter.cancel()
            self._ready.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

        try:
            asyncio.run(run())
        finally:
            self._ready.set()

    @property
    def port(self) -> int:
        return self.server._server.sockets[0].getsockname()[1]

    def start(self) -> "ServerThread":
        self._thread.start()
        self._ready.wait()
        if self._task is None or self._task.done():
            self._thread.join()
            raise RuntimeError("embedding server failed to start") from (
                None if self._task is None or self._task.cancelled()
                else self._task.exception())
        return self

    def stop(self, timeout: float = 60.0) -> None:
        async def shutdown():
            await self.server.close()
            self._task.cancel()

        if self._thread.is_alive():
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(
                timeout)
        self._thread.join(timeout)

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class ShardedLeader:
    """Rank 0's engine on a mesh, as the scheduler sees it: each
    ``eval_tokens`` first broadcasts its token lists to the other ranks
    (which run the same call in :func:`follow`), one batch at a time.
    Everything else is the engine's."""

    def __init__(self, model):
        self._model = model
        self._lock = threading.Lock()  # one batch's collectives at a time

    def __getattr__(self, name):
        return getattr(self._model, name)

    def eval_tokens(self, token_lists):
        import torch.distributed as dist

        with self._lock:
            dist.broadcast_object_list([[list(t) for t in token_lists]],
                                       src=0)
            return self._model.eval_tokens(token_lists)

    def stop_followers(self) -> None:
        import torch.distributed as dist

        with self._lock:
            dist.broadcast_object_list([None], src=0)


def follow(model) -> None:
    """A rank other than 0 on a mesh: run each batch rank 0 broadcasts
    through ``model.eval_tokens`` (its share of the collectives) until
    rank 0 broadcasts the stop. A batch that raises is logged and
    dropped, as rank 0's scheduler fails it and serves on, so that the
    ranks stay in step; a failure that strikes some ranks and not others
    part way through leaves the collectives out of step, which the
    process group's timeout ends."""
    import torch.distributed as dist

    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return
        try:
            model.eval_tokens(msg[0])
        except Exception:
            logger.exception("batch evaluation failed")


def main(argv=None) -> None:
    from .cli import add_common_args, load_model_from_args

    ap = argparse.ArgumentParser(
        "bert_tpu_torch.server", description="embedding server on the card "
        "(reference-wire-compatible, continuous batching)")
    add_common_args(ap)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="micro-batch cap per device step")
    ap.add_argument("--batch-window-ms", default="adaptive",
                    type=lambda s: s if s == "adaptive" else float(s),
                    help="'adaptive' (default): dispatch immediately when "
                    "the device slot is free and absorb arrivals while it "
                    "is busy; or a fixed wait in ms before running")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="micro-batches allowed in flight concurrently")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="pending-request backpressure bound (default "
                    "max_batch*128; 0 = unbounded)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running the bucket shapes at startup")
    ap.add_argument("--warmup-manifest", default=None, metavar="PATH",
                    help="warm only the shapes a previous run of this "
                    "config executed (written back on shutdown) instead "
                    "of the whole default grid")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    model = load_model_from_args(args, max_batch=args.max_batch)
    if not args.no_warmup:
        t0 = time.time()
        manifest = (args.warmup_manifest if args.warmup_manifest
                    and os.path.exists(args.warmup_manifest) else None)
        print(f"warming shapes from {manifest} ..." if manifest
              else "warming up bucket shapes ...", flush=True)
        # the serving grid doubles as the fallback for an unusable manifest
        model.warmup(batch_sizes=[1, 8, args.max_batch],
                     max_rows=args.max_batch, manifest=manifest)
        print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
    if model.mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            follow(model)
            return
        model = ShardedLeader(model)

    server = EmbeddingServer(model, host=args.host, port=args.port,
                             max_batch=args.max_batch,
                             batch_window_ms=args.batch_window_ms,
                             pipeline_depth=args.pipeline_depth,
                             queue_depth=args.queue_depth)

    # graceful SIGTERM: without it the process dies mid-eval and the
    # warmup-manifest write-back never runs
    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        asyncio.run(server.serve())
    except KeyboardInterrupt:
        pass
    finally:
        if isinstance(model, ShardedLeader):
            try:
                model.stop_followers()
            except RuntimeError as exc:  # a follower already gone
                logger.warning("could not stop the other ranks: %r", exc)
        if args.warmup_manifest:
            try:
                model.save_warmup_manifest(args.warmup_manifest)
            except OSError as exc:  # an unwritable path must not mask exit
                logger.warning("could not write warmup manifest %s: %r",
                               args.warmup_manifest, exc)


if __name__ == "__main__":
    main()
