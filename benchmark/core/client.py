"""A remote viewer: one closed-loop client of the network_gui protocol,
run as its own process (a real viewer does not share the server's
interpreter lock).

Usage: python client.py <job.json>

The job names the port, the request bodies (one per pose of the traffic,
sent in turn and wrapped around), the warm-up count, the window's
seconds, the frame size and the request indices whose frames to keep.
After all but the last warm-up request it prints ``ready`` and waits for
``arm`` on standard input; it sends the last warm-up request (on which
the server opens its window), then each request when the previous frame
has arrived,
until the window's seconds have passed, writes the latencies and the kept frames
to the job's output path, prints ``done`` and hangs up at the next line
on standard input. It imports only the standard library.
"""
from __future__ import annotations

import json
import socket
import sys
import time


def recv_exact(s: socket.socket, n: int, buf: bytearray) -> None:
    view = memoryview(buf)
    got = 0
    while got < n:
        k = s.recv_into(view[got:n], n - got)
        if not k:
            raise ConnectionError(f"server closed after {got}/{n} bytes")
        got += k


def connect(port: int, timeout: float = 60.0) -> socket.socket:
    deadline = time.monotonic() + timeout
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=120)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def main(job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    bodies = [b.encode("utf-8") for b in job["bodies"]]
    frame_bytes = job["width"] * job["height"] * 3
    frame = bytearray(frame_bytes)
    small = bytearray(4)
    keep = set(job["keep"])
    start = job["start"]

    def request(i: int):
        body = bodies[(start + i) % len(bodies)]
        s.sendall(len(body).to_bytes(4, "little") + body)
        recv_exact(s, frame_bytes, frame)
        recv_exact(s, 4, small)
        n = int.from_bytes(small, "little")
        if n:
            recv_exact(s, n, bytearray(n))

    s = connect(job["port"])
    with s:
        for i in range(job["warmup"] - 1):
            request(i - job["warmup"])
        print("ready", flush=True)
        if sys.stdin.readline().strip() != "arm":
            return
        request(-1)               # the server opens its window on this one
        lat, kept = [], {}
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            if ts - t0 >= job["seconds"]:
                break
            request(i)
            lat.append(time.perf_counter() - ts)
            if i in keep:
                kept[i] = bytes(frame)
            i += 1
        t1 = time.perf_counter()
        with open(job["out"], "wb") as f:
            head = json.dumps({"latency_s": lat, "window_s": t1 - t0,
                               "kept": sorted(kept)}).encode()
            f.write(len(head).to_bytes(8, "little") + head)
            for k in sorted(kept):
                f.write(kept[k])
        print("done", flush=True)
        sys.stdin.readline()      # "bye": hang up only when asked


if __name__ == "__main__":
    main(sys.argv[1])
