"""The public embedding engine: ``BertTorch``, the counterpart of
``bert_tpu.engine.BertTPU`` (and of the reference's C API, bert.h:33-82):

  reference                      bert_tpu_torch.BertTorch
  ---------                      ------------------------
  bert_load_from_file            BertTorch.from_file(path)
  bert_tokenize                  .tokenize(text)
  bert_encode                    .encode(text)
  bert_encode_batch              .encode_batch(texts)
  bert_eval / bert_eval_batch    .eval_tokens(token_lists)
  bert_n_embd                    .n_embd
  bert_n_max_tokens              .n_max_tokens
  bert_vocab_id_to_token         .id_to_token(id)

It runs on the card unless the caller asks for the CPU: ``device=None``
means ``"cuda"``, and without a CUDA device construction raises unless
``device="cpu"`` is passed. Inputs are routed exactly as BertTPU routes
them — short sentences packed several per row with block-diagonal
attention, the rest padded into length buckets — every batch is
dispatched before any result is gathered, and each result is copied
device→host without blocking into pinned memory as soon as its batch is
queued.

Each batch shape runs as one program, as bert_tpu jit-compiles each
(rows, T) shape once (``_graphs.py``): on the card a CUDA graph per
(rows, T, kind, regime) — kind bucketed or packed, regime the Q4/dense
tree or the int8 one — captured at the first sight of the shape (or by
``warmup``) and replayed for every later batch of that shape, so a batch
costs the host a few calls instead of one per op. The packed rows' valid
slots are gathered by a program of their own whose index is padded to a
multiple of 256, as bert_tpu pads it. On the CPU the same programs run
eagerly.

``use_kernels`` is bert_tpu's ``use_pallas`` (model.py): None launches
the kernels on the card; False runs every batch, int8 ones included,
through the plain PyTorch versions on any device; True is refused off the
card, at construction.

``from_file`` takes a ggml-bin file, an HF checkpoint directory or a
``.npz`` weight cache (``save_cache`` writes one). ``encode_iter`` /
``eval_tokens_iter`` stream a corpus with bounded memory. ``warmup``
captures each (rows, T) shape's program before the first request, or
only the shapes a previous run recorded in its manifest; on the card that
also builds the kernels. The process's CUDA graphs and the kernel ``.so``
cache of ``_kernels.py`` stand in for bert_tpu's XLA compilation cache;
graphs do not outlive the process. ``int8_eval=True`` adds bert_tpu's
opt-in W8A8 regime: batches of at least ``int8_threshold`` padded tokens
run on a per-column int8 weight tree (ops/int8_matmul.py).

Multi-device execution (``mesh=`` or ``dp=``/``tp=``, as BertTPU takes
them): one process per rank (parallel/multihost.py), every rank calling
the same method with the same inputs. Each batch is planned in multiples
of dp; a rank runs its rows through its Megatron shard of the weights
(tensor-parallel over ``model``), and the rows are all-gathered over
``data``, so every rank gets the whole result. A mesh engine runs its
batches eagerly, op by op: its collectives are not captured (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ._graphs import Programs
from .batching import (
    default_seq_buckets,
    pick_bucket,
    plan_buckets,
    size_bucket as _size_bucket,
)
from .loader import LoadedModel, load_model
from .model import BertModel, bert_forward, bert_forward_packed
from .ops.common import round_up as _round_up
from .ops.int8_matmul import Int8Tensor
from .packing import PackPlan, Placement, pack_batch, plan_packing
from .parallel.collectives import gather_rows
from .parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_size,
                            local_rows, make_mesh, rank_device)
from .parallel.sharding import check_tp_divisibility
from .parallel.spmd import shard_params
from .params import BertConfig, params_to_int8, params_to_torch
from .profiling import PhaseTimers
from .quant import QuantTensor
from .tokenizer import WordPieceTokenizer

_logger = logging.getLogger(__name__)
_WIRE_DTYPES = {"f32": torch.float32, "f16": torch.float16,
                "int8": torch.int8}


def resolve_device(device=None,
                   use_kernels: Optional[bool] = None) -> torch.device:
    """``None`` → the card. Raises when a CUDA device is asked for (or
    defaulted to) and none is present: nothing falls back to the CPU. A
    caller that asks for the kernels (``use_kernels=True``) on another
    device is refused here too, before any work."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bert_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if use_kernels and dev.type != "cuda":
        raise ValueError(f"use_kernels=True needs CUDA tensors, got {dev}")
    return dev


class BertTorch:
    """Sentence-embedding engine for BERT-family encoders on an H100."""

    def __init__(
        self,
        loaded: LoadedModel,
        *,
        device=None,
        compute_dtype: Optional[torch.dtype] = None,
        use_kernels: Optional[bool] = None,
        max_batch: int = 128,
        seq_buckets: Optional[Sequence[int]] = None,
        wire_dtype: Optional[str] = None,
        packing: bool = True,
        pack_seq: int = 64,
        pack_segments: int = 16,
        pooling: Optional[str] = None,
        int8_eval: bool = False,
        int8_threshold: int = 8192,
        mesh: Optional[Any] = None,
        dp: Optional[int] = None,
        tp: Optional[int] = None,
    ):
        self.device = resolve_device(device, use_kernels)
        # multi-device execution: mesh OR dp/tp build a (data, model) mesh
        # over the process group's ranks; this rank computes on its device
        if mesh is None and (dp or tp):
            mesh = make_mesh((dp or 1) * (tp or 1), tp=tp or 1,
                             device_type=self.device.type)
        self.mesh = mesh
        self._dp = axis_size(mesh, DATA_AXIS)
        self._tp = axis_size(mesh, MODEL_AXIS)
        if mesh is not None:
            self.device = rank_device(mesh)
        self.config: BertConfig = loaded.config
        self.vocab = loaded.vocab
        self.tokenizer = WordPieceTokenizer(loaded.vocab)
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                             else torch.float32)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.max_batch = max_batch
        self.seq_buckets = list(seq_buckets) if seq_buckets is not None else \
            default_seq_buckets(self.config.n_max_tokens)
        # Wire dtype of the device→host result copy. bf16 compute keeps 8
        # mantissa bits, so an f16 wire (10 bits) loses nothing relative to
        # it while halving the bytes; f32 compute keeps an exact f32 wire.
        # "int8" quarters the bytes (unit-norm outputs scaled by 127,
        # re-normalized on host).
        if wire_dtype is None:
            wire_dtype = "f16" if compute_dtype == torch.bfloat16 else "f32"
        if wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be f32/f16/int8, "
                             f"got {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        if pooling is None:
            pooling = loaded.pooling or "mean"
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be 'mean' or 'cls', "
                             f"got {pooling!r}")
        self.pooling = pooling
        self.timers = PhaseTimers()
        if self._dp & (self._dp - 1):
            raise ValueError(f"dp degree must be a power of two, "
                             f"got {self._dp}")
        if self.max_batch % self._dp:
            raise ValueError(f"max_batch {self.max_batch} must be a "
                             f"multiple of dp {self._dp}")
        # smallest row bucket: keeps every padded batch divisible by dp
        self._min_rows = max(8, self._dp)
        if self._tp > 1:
            quantized = any(isinstance(w, QuantTensor)
                            for w in loaded.params["layers"].values())
            check_tp_divisibility(self.config, self._tp, quantized=quantized)
        self._packing = packing
        self._pack_seq = min(pack_seq, self.config.n_max_tokens)
        self._pack_segments = pack_segments

        self.load_phases = dict(loaded.load_phases or {})
        # the host tree as loaded, for save_cache: the device copy holds
        # tables and dense weights in the compute dtype, which may be bf16
        self.host_params = loaded.params
        t0 = time.perf_counter()
        # tables and dense weights are stored in the compute dtype: the
        # model casts them to it at use, so the numbers are the same. On a
        # mesh, this rank's Megatron shard, laid out for the device alone
        state = self._place(loaded.params, compute_dtype)
        tp_group = axis_group(mesh, MODEL_AXIS)
        self._dp_group = axis_group(mesh, DATA_AXIS)
        self.model = BertModel(state, self.config, tp_group).eval()
        # W8A8 regime (ops/int8_matmul.py), opt-in as in bert_tpu: batches
        # of at least int8_threshold padded tokens run on a tree whose
        # matmul weights are per-column int8. With a nonzero threshold the
        # same sentence embeds slightly differently by batch size (cos >
        # 0.999); int8_threshold=0 sends every batch to int8. The int8
        # model shares the embedding tables, biases and LayerNorm
        # parameters with self.model: only its matmul weights are new.
        self._int8_threshold = int8_threshold
        self.model_int8 = None
        if int8_eval:
            host_i8 = params_to_int8(loaded.params)["layers"]
            int8_layers = self._place(
                {"embeddings": {}, "layers": {
                    k: v for k, v in host_i8.items()
                    if isinstance(v, Int8Tensor)}},
                torch.float32)["layers"]
            self.model_int8 = BertModel(
                {"embeddings": state["embeddings"],
                 "layers": {**state["layers"], **int8_layers}},
                self.config, tp_group).eval()
        # one program per batch shape; a mesh engine runs eagerly
        self._programs = None if mesh is not None else Programs(self.device)
        # a batch stages, replays and queues its copy to the host before
        # another thread's batch may touch the programs' static buffers
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_phases["to_device"] = round(time.perf_counter() - t0, 3)

    def _place(self, host_params, dtype: torch.dtype):
        """A host tree on this rank's device: whole, or on a mesh this
        rank's ``model``-axis shard."""
        if self.mesh is None:
            return params_to_torch(host_params, device=self.device,
                                   dtype=dtype)
        return shard_params(self.mesh, host_params, dtype=dtype)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, device=None,
                  quantize_ftype: Optional[int] = None,
                  **kw) -> "BertTorch":
        """Load a ggml-bin file, HF checkpoint directory or ``.npz`` weight
        cache onto ``device`` (default: the card)."""
        # fail before parsing the file
        resolve_device(device, kw.get("use_kernels"))
        return cls(load_model(path, quantize_ftype=quantize_ftype),
                   device=device, **kw)

    def save_cache(self, path: str) -> None:
        """Write the native .npz weight cache (stacked host params +
        vocab + pooling), in bert_tpu's format: reloads via from_file
        without parsing or repacking."""
        from .checkpoint import save_params

        save_params(path, self.host_params, self.config, self.vocab.tokens,
                    pooling=self.pooling)

    # -- introspection (bert.h:79-82) ---------------------------------------
    @property
    def n_embd(self) -> int:
        return self.config.n_embd

    @property
    def n_max_tokens(self) -> int:
        return self.config.n_max_tokens

    @property
    def n_vocab(self) -> int:
        return self.config.n_vocab

    def id_to_token(self, token_id: int) -> Optional[str]:
        return self.vocab.id_to_token(token_id)

    # -- tokenize ------------------------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        return self.tokenizer.tokenize(text, self.config.n_max_tokens)

    # -- evaluation ----------------------------------------------------------
    def eval_tokens(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Embed pre-tokenized inputs; returns [n, n_embd] f32 (L2-normed).

        Every batch is queued on the device first, each with its
        device→host copy, and the results are gathered once at the end, so
        the host pads the next batch while the device computes."""
        n = len(token_lists)
        out = np.empty((n, self.config.n_embd), dtype=np.float32)
        pending = self._dispatch_all(token_lists)
        self._gather_pending(pending, out)
        self.timers.add_sentences(n)
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _wire(self, emb: torch.Tensor) -> torch.Tensor:
        if self.wire_dtype == "f16":
            return emb.to(torch.float16)
        if self.wire_dtype == "int8":
            return torch.clamp(torch.round(emb * 127.0), -127, 127
                               ).to(torch.int8)
        return emb

    def _copy_to_host(self, emb: torch.Tensor):
        """Start the device→host copy of one batch's rows; returns the host
        tensor and the event that marks its arrival (None on the CPU)."""
        if self.device.type != "cuda":
            return emb, None
        host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
        host.copy_(emb, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @torch.inference_mode()
    def _dispatch_all(self, token_lists: Sequence[Sequence[int]]) -> list:
        """Route + dispatch every input; returns the pending
        (original-index array, host rows, arrival event) entries."""
        n = len(token_lists)
        lengths = [len(t) for t in token_lists]

        # Routing, as BertTPU routes: short sentences go through the packed
        # path (several per row, block-diagonal attention); everything else
        # through length-bucketed padding. Small batches ALWAYS pack; large
        # batches pack only when that pads fewer tokens than bucketing.
        pack_idx: List[int] = []
        pack_plan = None
        bucket_idx = list(range(n))
        if self._packing:
            short = [i for i in bucket_idx if lengths[i] <= self._pack_seq]
            use_packed = False
            if short:
                plan = plan_packing([lengths[i] for i in short],
                                    self._pack_seq, self._pack_segments)
                if len(short) <= 64:
                    use_packed = True
                else:
                    remaining = plan.n_rows
                    packed_tokens = 0
                    while remaining > 0:
                        chunk = min(remaining, self.max_batch)
                        packed_tokens += (_size_bucket(chunk,
                                                       self._min_rows)
                                          * self._pack_seq)
                        remaining -= chunk
                    bucketed_tokens = sum(
                        pick_bucket(lengths[i], self.seq_buckets)
                        for i in short
                    )
                    use_packed = packed_tokens <= 1.15 * bucketed_tokens
            if use_packed:
                pack_idx = short
                pack_plan = plan
                in_pack = set(short)
                bucket_idx = [i for i in bucket_idx if i not in in_pack]

        pending = []
        with self.timers.phase("dispatch"):
            if pack_idx:
                pending.extend(self._dispatch_packed(token_lists, pack_idx,
                                                     pack_plan))
            if bucket_idx:
                plan = plan_buckets([lengths[i] for i in bucket_idx],
                                    self.seq_buckets, self.max_batch,
                                    min_batch=self._dp)
                for seq_b, batch_b, sub in plan.groups:
                    idxs = [bucket_idx[j] for j in sub]
                    ids, mask = self.tokenizer.pad_batch(
                        [token_lists[i] for i in idxs], seq_b,
                        batch_size=batch_b
                    )
                    with self._lock:
                        host, done = self._copy_to_host(
                            self._forward(ids, mask)[: len(idxs)])
                    self.timers.record_bucket(batch_b, seq_b)
                    pending.append((np.asarray(idxs), host, done))
        return pending

    def _dispatch_packed(self, token_lists, idxs, plan=None):
        """Pack short sentences into fixed (rows, pack_seq) batches and
        dispatch them; returns pending entries."""
        tl = [token_lists[i] for i in idxs]
        if plan is None:
            plan = plan_packing([len(t) for t in tl], self._pack_seq,
                                self._pack_segments)
        pending = []
        row_cap = self.max_batch
        for start in range(0, plan.n_rows, row_cap):
            end = min(plan.n_rows, start + row_cap)
            pls = [Placement(p.index, p.row - start, p.offset, p.length,
                             p.slot)
                   for p in plan.placements if start <= p.row < end]
            sub = PackPlan(pls, end - start, plan.seq_len, plan.max_segments)
            n_rows = min(_size_bucket(sub.n_rows, self._min_rows), row_cap)
            ids, seg, pos, flat = pack_batch(tl, sub, n_rows=n_rows)
            with self._lock:
                host, done = self._copy_to_host(
                    self._forward_packed(ids, seg, pos, flat))
            self.timers.record_bucket(n_rows, self._pack_seq, kind="packed")
            orig = np.asarray([idxs[p.index] for p in pls])
            pending.append((orig, host, done))
        return pending

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Bucketed batch [B, T] (B a multiple of dp) → [B, D] in the wire
        dtype on this rank's device: its program's output (bert_tpu's
        ``encode``), or on a mesh this rank's rows through its shard,
        all-gathered over ``data``. The regime follows the whole batch's
        padded tokens."""
        model = self._model_for(ids.size)
        # ids are widened on the host: a cast on the card is one more launch
        ids = ids.astype(np.int64)

        def encode(ids, mask):
            return bert_forward(
                model, ids, mask, compute_dtype=self.compute_dtype,
                use_kernels=self.use_kernels, pooling=self.pooling)
        if self._programs is None:
            r = local_rows(self.mesh, ids.shape[0])
            return self._wire(gather_rows(encode(
                self._to_device(ids[r]), self._to_device(mask[r])),
                self._dp_group))
        arrays = {"ids": ids, "mask": mask}
        key = (*ids.shape, "bucketed", self._regime(model))
        return self._programs.get(
            key, lambda **a: self._wire(encode(**a)), arrays)(**arrays)

    def _forward_packed(self, ids: np.ndarray, seg: np.ndarray,
                        pos: np.ndarray, flat: np.ndarray) -> torch.Tensor:
        """Packed rows [B, pack_seq] → the valid slots' rows [n_sent, D]
        in the wire dtype, ``flat`` indexing them in the flattened [B·S]
        per-segment output: the packed program's output (bert_tpu's
        ``encode_packed``), gathered by a second program whose index is
        padded to a multiple of 256 (``gather_segments``); on a mesh, as
        :meth:`_forward`, then gathered eagerly."""
        model = self._model_for(ids.size)
        ids, pos = ids.astype(np.int64), pos.astype(np.int64)
        flat = flat.astype(np.int64)
        d = self.config.n_embd

        def encode_packed(ids, seg, pos):
            return bert_forward_packed(
                model, ids, seg, pos, n_segments=self._pack_segments,
                compute_dtype=self.compute_dtype,
                use_kernels=self.use_kernels, pooling=self.pooling)
        if self._programs is None:
            r = local_rows(self.mesh, ids.shape[0])
            emb3 = gather_rows(encode_packed(
                self._to_device(ids[r]), self._to_device(seg[r]),
                self._to_device(pos[r])), self._dp_group)
            return self._wire(emb3.reshape(-1, d)[self._to_device(flat)])
        arrays = {"ids": ids, "seg": seg, "pos": pos}
        key = (*ids.shape, "packed", self._regime(model))
        packed = self._programs.get(key, encode_packed, arrays)
        packed(**arrays)

        def gather_segments(flat):
            # reads the packed program's output as its last call left it
            return self._wire(packed.output.reshape(-1, d)[flat])
        n = flat.size
        flat_pad = np.zeros(max(_round_up(n, 256), 256), dtype=np.int64)
        flat_pad[:n] = flat
        gather = self._programs.get((*key, flat_pad.size), gather_segments,
                                    {"flat": flat_pad})
        return gather(flat=flat_pad)[:n]

    def _model_for(self, n_tokens: int) -> BertModel:
        """The model for a batch of ``n_tokens`` padded tokens (rows × T):
        the int8 one at or above the threshold, when there is one."""
        if self.model_int8 is not None and n_tokens >= self._int8_threshold:
            return self.model_int8
        return self.model

    def _regime(self, model: BertModel) -> str:
        return "int8" if model is self.model_int8 else "q4/dense"

    def _gather_pending(self, pending: list, out: np.ndarray) -> None:
        """Wait for each batch's host copy and place its rows in ``out``."""
        with self.timers.phase("gather"):
            for idxs, host, done in pending:
                if done is not None:
                    done.synchronize()
                out[idxs] = host.numpy().astype(np.float32)
        if self.wire_dtype == "int8":
            # fixed-point wire: undo the 127 scale by re-normalizing (outputs
            # are unit-norm by construction, bert.cpp:911-913 semantics)
            norms = np.linalg.norm(out, axis=-1, keepdims=True)
            np.divide(out, np.maximum(norms, 1e-12), out=out)

    # -- streaming corpus-scale evaluation ----------------------------------
    def eval_tokens_iter(self, token_lists: Sequence[Sequence[int]],
                         window: int = 4096, depth: int = 4):
        """Embed an arbitrarily large pre-tokenized corpus with bounded
        memory: yields [≤window, n_embd] f32 blocks in input order. At most
        ``depth`` windows are in flight — windows i+1..i+depth-1 are
        dispatched before window i is gathered, so the card computes (and
        its result copies run) ahead while the host places results.
        Residency is O(depth × window)."""
        return self._stream(len(token_lists), window, depth,
                            lambda s, e: token_lists[s:e])

    def encode_iter(self, texts: Sequence[str], window: int = 4096,
                    depth: int = 4):
        """Streaming :meth:`encode_batch`: tokenize and embed one window at
        a time, yielding [≤window, n_embd] blocks in input order."""
        def toks(s, e):
            with self.timers.phase("tokenize"):
                return self.tokenizer.tokenize_batch(
                    texts[s:e], self.config.n_max_tokens)
        return self._stream(len(texts), window, depth, toks)

    def _stream(self, n: int, window: int, depth: int, window_tokens):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return self._stream_gen(n, window, depth, window_tokens)

    def _stream_gen(self, n, window, depth, window_tokens):
        q: deque = deque()  # (start, end, pending)
        for s in range(0, n, window):
            e = min(n, s + window)
            q.append((s, e, self._dispatch_all(window_tokens(s, e))))
            if len(q) >= depth:
                yield self._materialize_window(q.popleft())
        while q:
            yield self._materialize_window(q.popleft())

    def _materialize_window(self, item) -> np.ndarray:
        s, e, pending = item
        out = np.empty((e - s, self.config.n_embd), dtype=np.float32)
        self._gather_pending(pending, out)
        self.timers.add_sentences(e - s)
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize + embed a batch of sentences (bert_encode_batch)."""
        with self.timers.phase("tokenize"):
            toks = self.tokenizer.tokenize_batch(texts,
                                                 self.config.n_max_tokens)
        return self.eval_tokens(toks)

    def encode(self, text: str) -> np.ndarray:
        """Single-sentence convenience (bert_encode, bert.cpp:943-950)."""
        return self.encode_batch([text])[0]

    def stats(self) -> dict:
        """Host-side phase timings + bucket execution counts, plus the
        load-phase breakdown (parse / emb_dequant / repack / quantize /
        to_device, seconds)."""
        out = self.timers.summary()
        out["load_phases"] = dict(self.load_phases)
        return out

    # -- warmup --------------------------------------------------------------
    @torch.inference_mode()
    def _warm_shape(self, rows: int, seq: int, kind: str) -> None:
        """Capture (on the CPU: run) one (rows, seq) shape's program on
        zeros, through its host copy."""
        ids = np.zeros((rows, seq), dtype=np.int64)
        with self._lock:
            if kind == "packed":
                emb = self._forward_packed(ids, ids.astype(np.int32), ids,
                                           np.zeros(1, dtype=np.int64))
            else:
                emb = self._forward(ids, np.ones((rows, seq),
                                                 dtype=np.float32))
            _, done = self._copy_to_host(emb)
        if done is not None:
            done.synchronize()

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               max_rows: Optional[int] = None,
               manifest: Optional[Any] = None) -> None:
        """Capture the program of every shape a server will meet, before
        its first request, as bert_tpu compiles them; on the card this
        also builds the kernels. A shape first met later is captured then.

        With ``manifest`` (a path written by :meth:`save_warmup_manifest`,
        or its ``shapes`` list), warms exactly the shapes a previous run
        executed; a corrupt or empty manifest, or one written for another
        model, falls back to the grid below. Otherwise warms the bucketed
        (B, T) grid for ``batch_sizes`` (default: 1, 8 and max_batch) plus
        every packed row bucket up to ``max_rows`` (default max_batch)."""
        if manifest is not None:
            shapes = self._load_manifest_shapes(manifest)
            if shapes:
                for rows, seq, kind in shapes:
                    self._warm_shape(rows, seq, kind)
                return
            _logger.warning("warmup manifest unusable or empty — "
                            "falling back to the grid")
        if batch_sizes is None:
            batch_sizes = sorted({self._dp,
                                  min(max(8, self._dp), self.max_batch),
                                  self.max_batch})
        else:
            batch_sizes = sorted({min(_round_up(b, self._dp),
                                      self.max_batch)
                                  for b in batch_sizes})
        for t in self.seq_buckets:
            for b in batch_sizes:
                self._warm_shape(b, t, "bucketed")
        if self._packing:
            cap = min(max_rows or self.max_batch, self.max_batch)
            for r in sorted({min(_size_bucket(r, self._min_rows), cap)
                             for r in range(1, cap + 1)}):
                self._warm_shape(r, self._pack_seq, "packed")

    def _load_manifest_shapes(self, manifest) -> List[tuple]:
        """Parse + validate a warmup manifest (path or ``shapes`` list) into
        (rows, seq, kind) tuples for this engine: tolerates corrupt files,
        rejects manifests recorded for another model, rounds rows up to
        dp and clamps them to max_batch, and snaps seq to this engine's
        buckets. Returns [] when nothing usable remains."""
        raw = manifest
        if isinstance(manifest, (str, bytes)):
            try:
                with open(manifest, encoding="utf-8") as f:
                    data = json.load(f)
                meta = data.get("model") or {}
                if meta and (meta.get("n_embd") != self.config.n_embd or
                             meta.get("n_layer") != self.config.n_layer):
                    _logger.warning(
                        "warmup manifest %s was recorded for a different "
                        "model (%s) — ignoring", manifest, meta)
                    return []
                raw = data["shapes"]
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError) as exc:
                _logger.warning("could not read warmup manifest %s: %r",
                                manifest, exc)
                return []
        shapes = set()
        try:
            for sh in raw:
                rows, seq = int(sh["rows"]), int(sh["seq"])
                kind = sh.get("kind", "bucketed")
                if rows < 1 or kind not in ("bucketed", "packed"):
                    continue
                if not 1 <= seq <= self.config.n_max_tokens:
                    continue
                rows = min(_round_up(rows, self._dp), self.max_batch)
                seq = (self._pack_seq if kind == "packed"
                       else pick_bucket(seq, self.seq_buckets))
                shapes.add((rows, seq, kind))
        except (TypeError, KeyError, ValueError, AttributeError) as exc:
            _logger.warning("malformed warmup manifest shapes: %r", exc)
            return []
        return sorted(shapes)

    def seen_shapes(self) -> List[Dict[str, Any]]:
        """The (rows, seq) shapes this engine has executed (from the bucket
        counters) — the warmup set a serving config really needs."""
        return [{"rows": b, "seq": s,
                 "kind": "packed" if kind == "packed" else "bucketed"}
                for (b, s, kind) in sorted(self.timers.bucket_counts)]

    def save_warmup_manifest(self, path: str) -> None:
        """Persist the union of ``seen_shapes()`` and any shapes already in
        ``path`` (bert_tpu's manifest format), written atomically."""
        shapes = {(s["rows"], s["seq"], s["kind"])
                  for s in self.seen_shapes()}
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    for s in json.load(f)["shapes"]:
                        shapes.add((int(s["rows"]), int(s["seq"]),
                                    s.get("kind", "bucketed")))
            except (ValueError, KeyError, TypeError):
                pass  # corrupt manifest: rewrite from scratch
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({
                "version": 1,
                "model": {"n_embd": self.config.n_embd,
                          "n_layer": self.config.n_layer},
                "shapes": [{"rows": r, "seq": s, "kind": k}
                           for r, s, k in sorted(shapes)],
            }, f, indent=1)
        os.replace(tmp, path)
