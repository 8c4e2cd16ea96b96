"""The open-loop load generator of the ``serve`` loop, run as a child
process (``python3 -m gpubench.loadgen``) so that its Python does not
share the server's interpreter lock.

It speaks the reference wire: on connect the server sends ``n_embd`` as
an int32; a request is one UTF-8 text in one message; the reply is
``n_embd`` float32s. A connection carries one request at a time.

Protocol with the parent, over stdin and stdout (pickle): the parent
sends the plan (port, connections, the warm-up's and the window's texts
and due offsets, the window's length, the grace and the indices of the
window's requests whose replies to keep). The child connects, runs the
warm-up schedule to its end and reports; waits for one byte from the
parent; then starts the window at ``t0`` (reported first), sends each
request when due or, when every connection is busy, as soon as one frees,
keeps sending requests due in the window after it has closed, and waits
for their replies until ``grace_s`` past its close. The warm-up waits for
every reply (up to ``warm_grace_s``), so that no connection enters the
window with a request outstanding. Latency runs from the
time a request was due to the last byte of its reply.
"""

from __future__ import annotations

import pickle
import selectors
import socket
import struct
import sys
import time

import numpy as np


def _connect(port: int, n: int):
    conns = []
    for _ in range(n):
        s = socket.create_connection(("127.0.0.1", port))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        head = b""
        while len(head) < 4:
            more = s.recv(4 - len(head))
            if not more:
                raise ConnectionError("server closed during the handshake")
            head += more
        conns.append(s)
    return conns, struct.unpack("<i", head)[0]


def schedule(conns, n_embd: int, texts, due, t0: float, stop: float,
             keep=()) -> dict:
    """Send ``texts[i]`` at ``t0 + due[i]`` over free connections; wait for
    replies until monotonic time ``stop``. Returns sent and done times
    (NaN where none) and the kept replies."""
    need = 4 * n_embd
    n = len(texts)
    payload = [t.encode("utf-8") for t in texts]
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    keep = set(int(k) for k in keep)
    kept = {}
    sel = selectors.DefaultSelector()
    idle = list(conns)
    state = {}
    for s in conns:
        sel.register(s, selectors.EVENT_READ)
    nxt = 0
    outstanding = 0
    stray = []  # byte counts read on idle connections (0: a close)
    while nxt < n or outstanding:
        now = time.monotonic()
        if now > stop:
            break
        while nxt < n and idle and t0 + due[nxt] <= now:
            s = idle.pop()
            s.sendall(payload[nxt])
            sent[nxt] = time.monotonic()
            state[s] = [nxt, bytearray()]
            nxt += 1
            outstanding += 1
        if nxt < n and idle:
            timeout = max(0.0, t0 + due[nxt] - time.monotonic())
        else:
            timeout = max(0.0, stop - time.monotonic())
        for key, _ in sel.select(min(timeout, 0.05)):
            s = key.fileobj
            if s not in state:  # bytes or a close on an idle connection
                more = s.recv(1 << 16)
                stray.append(len(more))
                if not more:
                    sel.unregister(s)
                    idle.remove(s)
                    conns.remove(s)
                continue
            i, buf = state[s]
            more = s.recv(need - len(buf))
            if not more:  # the server closed it: the request has failed
                stray.append(0)
                sel.unregister(s)
                conns.remove(s)
                del state[s]
                outstanding -= 1
                continue
            buf += more
            if len(buf) == need:
                done[i] = time.monotonic()
                if i in keep:
                    kept[i] = np.frombuffer(bytes(buf), "<f4").copy()
                del state[s]
                idle.append(s)
                outstanding -= 1
    sel.close()
    return {"sent": sent, "done": done, "kept": kept, "t0": t0,
            "stray_reads": stray}


def main() -> None:
    plan = pickle.load(sys.stdin.buffer)
    out = sys.stdout.buffer
    conns, n_embd = _connect(plan["port"], plan["connections"])
    texts, due = plan["warm"]
    t0 = time.monotonic() + 0.01
    warm = schedule(conns, n_embd, texts, due, t0,
                    t0 + (due[-1] if len(due) else 0) + plan["warm_grace_s"])
    pickle.dump({"warm_done": int(np.isfinite(warm["done"]).sum()),
                 "warm_sent": int(np.isfinite(warm["sent"]).sum()),
                 "warm_due": len(due), "stray_reads": warm["stray_reads"]},
                out)
    out.flush()
    if sys.stdin.buffer.read(1) != b"g":
        return
    texts, due = plan["window"]
    t0 = time.monotonic() + 0.01
    pickle.dump({"t0": t0}, out)
    out.flush()
    result = schedule(conns, n_embd, texts, due, t0,
                      t0 + plan["seconds"] + plan["grace_s"], plan["keep"])
    for s in conns:
        s.close()
    pickle.dump(result, out)
    out.flush()


if __name__ == "__main__":
    main()
