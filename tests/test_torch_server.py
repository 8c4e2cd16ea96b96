"""The port's embedding server on the CPU, over real sockets.

An in-process ``bert_tpu_torch.server.EmbeddingServer`` serves a CPU
``BertTorch`` loaded from a d_head 26 HF directory
(tests/test_torch_loader.py writes it). Replies are held to the engine's
own results on the same inputs (atol 1e-5: the same f32 arithmetic in
other batch compositions) over the reference wire (text → n_embd f32) and
the framed EVAL / BATCH / META / STATS / STATS2 messages, byte for byte as
bert_tpu's server speaks them. ``csrc/libbert.so`` in host:port mode and
the command-line entry points run against the port as well. No test here
asserts a timing window.
"""

import asyncio
import ctypes
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bert_tpu_torch import BertTorch
from bert_tpu_torch.server import (
    BIN_BATCH_MAGIC,
    BIN_EVAL_MAGIC,
    BIN_META_MAGIC,
    BIN_STATS2_MAGIC,
    BIN_STATS_MAGIC,
    MAX_BATCH_SENTENCES,
    EmbeddingServer,
    ServerThread,
)
from test_torch_loader import HF_SMALL, write_hf_dir

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = HF_SMALL["n_embd"]
TEXTS = ["going to the store", "you are welcome to come along",
         "the time is partly cloudy outside " * 12, "Québec", ""]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("srv") / "hf", fmt="bin")


@pytest.fixture(scope="module")
def model(hf_dir):
    return BertTorch.from_file(hf_dir, device="cpu", max_batch=8)


def _run_with_server(model, coro_fn, **server_kw):
    async def go():
        server = EmbeddingServer(model, host="127.0.0.1", port=0,
                                 **server_kw)
        ready = asyncio.Event()
        task = asyncio.get_running_loop().create_task(server.serve(ready))
        await ready.wait()
        port = server._server.sockets[0].getsockname()[1]
        try:
            return await coro_fn(server, port)
        finally:
            await server.close()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    return asyncio.run(go())


async def _connect(port):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    (n_embd,) = struct.unpack("<i", await reader.readexactly(4))
    return reader, writer, n_embd


def _batch_frame(token_lists):
    body = b"".join(struct.pack("<i", len(t)) + np.asarray(t, "<i4").tobytes()
                    for t in token_lists)
    return BIN_BATCH_MAGIC + struct.pack("<i", len(token_lists)) + body


def test_text_round_trip_equals_encode(model):
    async def scenario(server, port):
        reader, writer, n_embd = await _connect(port)
        outs = []
        for text in TEXTS[:4]:
            writer.write(text.encode("utf-8"))
            await writer.drain()
            outs.append(np.frombuffer(await reader.readexactly(4 * n_embd),
                                      "<f4"))
        writer.close()
        return n_embd, outs

    n_embd, outs = _run_with_server(model, scenario)
    assert n_embd == D
    for text, emb in zip(TEXTS, outs):
        np.testing.assert_allclose(emb, model.encode(text), atol=1e-5)


def test_concurrent_text_clients(model):
    async def client(port, text):
        reader, writer, n_embd = await _connect(port)
        writer.write(text.encode())
        await writer.drain()
        out = np.frombuffer(await reader.readexactly(4 * n_embd), "<f4")
        writer.close()
        return out

    async def scenario(server, port):
        outs = await asyncio.gather(*(client(port, t) for t in TEXTS[:4] * 3))
        return outs, server.scheduler.n_served

    outs, served = _run_with_server(model, scenario)
    assert served == 12
    want = model.encode_batch(TEXTS[:4] * 3)
    np.testing.assert_allclose(np.stack(outs), want, atol=1e-5)


def test_framed_messages(model):
    toks = [model.tokenize(t) for t in TEXTS[:4]]

    async def scenario(server, port):
        reader, writer, n_embd = await _connect(port)
        got = {}
        writer.write(BIN_EVAL_MAGIC + struct.pack("<i", len(toks[1]))
                     + np.asarray(toks[1], "<i4").tobytes())
        await writer.drain()
        got["eval"] = np.frombuffer(await reader.readexactly(4 * n_embd),
                                    "<f4")
        # a zero-token record embeds like the empty id list does
        writer.write(_batch_frame(toks + [[]]))
        await writer.drain()
        got["batch"] = np.frombuffer(
            await reader.readexactly(5 * 4 * n_embd), "<f4").reshape(5, -1)
        for name, magic, n in (("meta", BIN_META_MAGIC, 12),
                               ("stats", BIN_STATS_MAGIC, 16),
                               ("stats2", BIN_STATS2_MAGIC, 32)):
            writer.write(magic)
            await writer.drain()
            reply = await reader.readexactly(4 + n)
            assert reply[:4] == magic
            got[name] = reply[4:]
        writer.close()
        return got

    got = _run_with_server(model, scenario)
    np.testing.assert_allclose(got["eval"], model.eval_tokens([toks[1]])[0],
                               atol=1e-5)
    np.testing.assert_allclose(got["batch"], model.eval_tokens(toks + [[]]),
                               atol=1e-5)
    assert struct.unpack("<iii", got["meta"]) == (1, D, 256)
    assert struct.unpack("<QQ", got["stats"])[0] == 6  # 1 eval + 5 batch
    served, batches, n, p50, p95, p99 = struct.unpack("<QQIIII",
                                                      got["stats2"])
    assert served == 6 and 1 <= batches <= 6 and n == 6
    assert 0 < p50 <= p95 <= p99


@pytest.mark.parametrize("frame", ["eval_oov", "batch_oov", "eval_negative"])
def test_out_of_vocab_id_closes_connection(model, frame):
    bad = {"eval_oov": BIN_EVAL_MAGIC + struct.pack("<ii", 1, 30522),
           "batch_oov": _batch_frame([[101, 102], [101, 40000, 102]]),
           "eval_negative": BIN_EVAL_MAGIC + struct.pack("<ii", 1, -3)}[frame]

    async def scenario(server, port):
        reader, writer, _ = await _connect(port)
        writer.write(bad)
        await writer.drain()
        tail = await reader.read()  # EOF: the server closed the connection
        writer.close()
        return tail, server.scheduler.n_served

    tail, served = _run_with_server(model, scenario)
    assert tail == b"" and served == 0


@pytest.mark.parametrize("frame", ["too_many_sentences", "zero_sentences",
                                   "too_many_tokens"])
def test_oversized_batch_rejected(model, frame):
    bad = {"too_many_sentences": BIN_BATCH_MAGIC + struct.pack(
               "<i", MAX_BATCH_SENTENCES + 1),
           "zero_sentences": BIN_BATCH_MAGIC + struct.pack("<i", 0),
           "too_many_tokens": BIN_BATCH_MAGIC + struct.pack("<ii", 1, 257)
           }[frame]

    async def scenario(server, port):
        reader, writer, _ = await _connect(port)
        writer.write(bad)
        await writer.drain()
        tail = await reader.read()
        writer.close()
        return tail

    assert _run_with_server(model, scenario) == b""


def test_server_thread_serves_and_stops(model):
    with ServerThread(model) as st:
        with socket.create_connection(("127.0.0.1", st.port)) as s:
            assert struct.unpack("<i", s.recv(4)) == (D,)
            s.sendall(b"going to the store")
            buf = b""
            while len(buf) < 4 * D:
                buf += s.recv(4 * D - len(buf))
        np.testing.assert_allclose(np.frombuffer(buf, "<f4"),
                                   model.encode("going to the store"),
                                   atol=1e-5)
    assert not st._thread.is_alive()


@pytest.fixture(scope="module")
def libbert(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    out = str(tmp_path_factory.mktemp("cabi") / "libbert.so")
    csrc = os.path.join(REPO, "csrc")
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                    out, os.path.join(csrc, "bert_client.cpp"),
                    os.path.join(csrc, "wordpiece.cpp")], check=True,
                   timeout=600)
    lib = ctypes.CDLL(out)
    lib.bert_load_from_file.restype = ctypes.c_void_p
    lib.bert_load_from_file.argtypes = [ctypes.c_char_p]
    lib.bert_free.argtypes = [ctypes.c_void_p]
    for fn in ("bert_n_embd", "bert_n_max_tokens"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.bert_encode.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float)]
    lib.bert_eval.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_float)]
    return lib


def test_libbert_hostport_round_trip(libbert, model):
    """The reference's C ABI (csrc/libbert.so) against the port's server:
    META learns n_max_tokens, bert_encode rides the text wire, bert_eval
    the framed EVAL message."""
    with ServerThread(model) as st:
        handle = libbert.bert_load_from_file(f"127.0.0.1:{st.port}".encode())
        assert handle
        try:
            assert libbert.bert_n_embd(handle) == D
            assert libbert.bert_n_max_tokens(handle) == 256  # not 512
            out = (ctypes.c_float * D)()
            libbert.bert_encode(handle, 1, TEXTS[1].encode(), out)
            np.testing.assert_allclose(np.ctypeslib.as_array(out),
                                       model.encode(TEXTS[1]), atol=1e-5)
            ids = model.tokenize(TEXTS[2])
            arr = (ctypes.c_int32 * len(ids))(*ids)
            libbert.bert_eval(handle, 1, arr, len(ids), out)
            np.testing.assert_allclose(np.ctypeslib.as_array(out),
                                       model.eval_tokens([ids])[0],
                                       atol=1e-5)
        finally:
            libbert.bert_free(handle)


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}


def test_cli_runs_on_the_cpu(hf_dir, model):
    r = subprocess.run(
        [sys.executable, "-m", "bert_tpu_torch.cli", "-m", hf_dir,
         "--device", "cpu", "-p", TEXTS[0]], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert str(model.tokenize(TEXTS[0])) in r.stdout
    assert f"embedding ({D}):" in r.stdout and "device      = cpu" in r.stdout


def test_server_main_serves_and_writes_its_manifest(hf_dir, model, tmp_path):
    """``python -m bert_tpu_torch.server --device cpu``: warms up, serves
    the wire, and on SIGTERM writes the shapes it ran to its manifest."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    manifest = str(tmp_path / "manifest.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bert_tpu_torch.server", "-m", hf_dir,
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--max-batch", "8", "--warmup-manifest", manifest],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while True:
            try:
                conn = socket.create_connection(("127.0.0.1", port), 1)
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.2)
        with conn:
            assert struct.unpack("<i", conn.recv(4)) == (D,)
            conn.sendall(TEXTS[0].encode())
            buf = b""
            while len(buf) < 4 * D:
                buf += conn.recv(4 * D - len(buf))
        np.testing.assert_allclose(np.frombuffer(buf, "<f4"),
                                   model.encode(TEXTS[0]), atol=1e-5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert "warmup done" in out
    with open(manifest) as f:
        shapes = json.load(f)["shapes"]
    assert {"rows": 8, "seq": 64, "kind": "packed"} in shapes
