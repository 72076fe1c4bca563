"""CI server smoke: boot the port's demo HTTP server as a real subprocess,
drive it over real HTTP, SIGTERM it, and assert a clean drain.

    PYTHONPATH=src python -m repro_torch.scripts.server_smoke [--device cpu]

What it checks (the process-boundary contract of the HTTP/SSE front end):

1. the server subprocess (``python -m repro_torch.serving.server --port
   0``, on ``--device``) comes up and prints its bound port;
2. ``/healthz`` 200, ``/readyz`` 200, ``/metrics`` non-empty and
   carrying the serving counters;
3. one streamed generation over real HTTP completes (``event: done``
   with state ``finished``);
4. SIGTERM: exit code 0, drain report printed with every request
   terminal (``sum(terminal) == submitted``) and the allocator clean —
   zero leaked pages.

Exit 0 on success, 1 with a diagnosis otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

SRC = pathlib.Path(__file__).resolve().parent.parent.parent


def http(port: int, method: str, path: str, body: dict | None = None,
         timeout_s: float = 60.0):
    """(code, headers, payload) over one blocking socket."""
    data = b"" if body is None else json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as s:
        s.sendall((f"{method} {path} HTTP/1.1\r\nHost: s\r\n"
                   f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    head, _, payload = raw.partition(b"\r\n\r\n")
    headers = {}
    for line in head.split(b"\r\n")[1:]:
        if b": " in line:
            k, v = line.decode().split(": ", 1)
            headers[k.lower()] = v
    return int(head.split()[1]), headers, payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the server's engine runs")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.serving.server",
         "--port", "0", "--max-queue-depth", "64", "--device", args.device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    port = None
    lines = []
    try:
        # 1. startup: the port line must appear
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if m := re.search(r"serving on http://[\d.]+:(\d+)", line):
                port = int(m.group(1))
                break
        if port is None:
            print("FAIL: server never printed its port\n" + "".join(lines))
            return 1
        print(f"server up on :{port} ({args.device})")

        # 2. health + readiness + metrics
        code, _, body = http(port, "GET", "/healthz")
        if code != 200:
            raise AssertionError(f"/healthz {code}")
        code, _, body = http(port, "GET", "/readyz")
        if code != 200:
            raise AssertionError(f"/readyz {code}: {body!r}")
        code, _, metrics = http(port, "GET", "/metrics")
        if code != 200 or not metrics:
            raise AssertionError("/metrics empty")
        for needle in (b"serving_requests_submitted_total",
                       b"serving_requests_shed_total",
                       b"serving_supervisor_restarts_total"):
            if needle not in metrics:
                raise AssertionError(f"{needle!r} missing from /metrics")
        print(f"healthz/readyz/metrics OK ({len(metrics)}B scrape)")

        # 3. one streamed generation over real HTTP
        code, _, payload = http(port, "POST", "/v1/generate",
                                {"prompt": [1, 2, 3, 4], "max_new": 8,
                                 "stream": True})
        if code != 200:
            raise AssertionError(f"generate {code}")
        text = payload.decode()
        tokens = re.findall(r"^event: token$", text, re.M)
        done = [json.loads(line[5:]) for line in text.splitlines()
                if line.startswith("data:")][-1]
        if not tokens:
            raise AssertionError("no token events streamed")
        if done["state"] != "finished" or done["n_tokens"] != 8:
            raise AssertionError(str(done))
        print(f"streamed {done['n_tokens']} tokens over SSE "
              f"({len(tokens)} events)")

        # 4. SIGTERM -> clean drain
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
        if proc.returncode != 0:
            raise AssertionError(f"server exited {proc.returncode}:\n{out}")
        m = re.search(r"drain report: (\{.*\})", out)
        if not m:
            raise AssertionError(f"no drain report in output:\n{out}")
        report = json.loads(m.group(1))
        if not (report["clean"] and report["allocator_clean"]
                and report["terminal_sum"] == report["submitted"]):
            raise AssertionError(str(report))
        print("SIGTERM drain clean: "
              f"submitted={report['submitted']} "
              f"terminal={report['terminal']} "
              f"allocator={report['allocator']}")
        print("server smoke PASS")
        return 0
    except AssertionError as exc:
        print(f"FAIL: {exc}")
        return 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())
