"""Persistent engine server: one warm GPU process, many CLI requests.

The reference binary restarts per invocation because CPU process startup
is free (main.rs:7-16 just dispatches and exits).  On an accelerator it
is not: every new process starts the device client and compiles its
programs before reaching steady state.  A resident engine process pays
that once; every later request starts at the warm steady state with the
module-level jit and flush-fn caches intact.

Usage:
    orion-kmer-tpu serve --socket /tmp/okt.sock                    # server
    orion-kmer-tpu --server /tmp/okt.sock count -k 21 ...          # client
    orion-kmer-tpu --server /tmp/okt.sock shutdown                 # stop it

Protocol: one request per SOCK_STREAM unix-socket connection.  The client
sends one JSON line ``{"argv": [...]}``; the server runs the argv through
the normal CLI dispatch in-process (same parse, same commands, same error
rendering as a fresh process — per-request ``setup_logging`` binds the
captured stderr) and replies with one JSON line
``{"rc": int, "stdout": str, "stderr": str}``.  The accept loop is
strictly sequential — ONE in-flight request at a time — so one process
holds the device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys

SHUTDOWN_WORD = "shutdown"


def _recv_line(conn: socket.socket, limit: int = 64 << 20) -> bytes | None:
    """Read up to the first newline (or EOF); None on empty connection."""
    chunks: list[bytes] = []
    total = 0
    while True:
        data = conn.recv(1 << 16)
        if not data:
            break
        chunks.append(data)
        total += len(data)
        if b"\n" in data:
            break
        if total > limit:
            raise ValueError("request line exceeds limit")
    if not chunks:
        return None
    return b"".join(chunks).split(b"\n", 1)[0]


def _send_reply(conn: socket.socket, reply: dict) -> None:
    conn.sendall(json.dumps(reply).encode() + b"\n")


def run_request(argv: list[str]) -> dict:
    """Run one CLI argv in-process, capturing stdout/stderr and rc.

    SystemExit (argparse usage errors, --version, --help) is translated
    to its exit code; any other exception is rendered to the captured
    stderr and mapped to rc 1 so a bad request can never kill the
    server.  Nested ``serve`` is refused (one resident process, not a
    tree of them).
    """
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if argv and argv[0] == "serve":
            print("[ERROR orion_kmer_tpu] Error: cannot nest serve", file=sys.stderr)
            rc = 2
        else:
            from .cli import main

            try:
                rc = main(list(argv))
            except SystemExit as e:
                code = e.code
                rc = code if isinstance(code, int) else (0 if code is None else 2)
            except Exception:
                import traceback

                traceback.print_exc(file=sys.stderr)
                rc = 1
    return {"rc": rc, "stdout": out.getvalue(), "stderr": err.getvalue()}


def serve(socket_path, on_ready=None) -> None:
    """Bind ``socket_path`` and answer requests until ``shutdown``.

    The first request of each kind pays its compiles; later ones reuse
    them.  ``on_ready`` fires once listening (tests use it to
    rendezvous).
    """
    path = os.fspath(socket_path)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(8)
        if on_ready is not None:
            on_ready()
        print(f"[serve] listening on {path}", file=sys.stderr, flush=True)
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    raw = _recv_line(conn)
                    if raw is None:
                        continue
                    try:
                        argv = json.loads(raw)["argv"]
                        assert isinstance(argv, list)
                    except Exception:
                        _send_reply(
                            conn,
                            {"rc": 2, "stdout": "", "stderr": "[serve] bad request\n"},
                        )
                        continue
                    argv = [str(a) for a in argv]
                    if argv == [SHUTDOWN_WORD]:
                        _send_reply(conn, {"rc": 0, "stdout": "", "stderr": ""})
                        break
                    _send_reply(conn, run_request(argv))
                except (BrokenPipeError, ConnectionError):
                    continue  # client went away mid-reply; keep serving
    finally:
        srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


def forward(socket_path, argv, stdout=None, stderr=None) -> int:
    """Send one argv to a running server; relay its stdout/stderr; return rc.

    No socket timeout on purpose: a forwarded ``count`` over a large
    input legitimately runs for minutes to hours.
    """
    path = os.fspath(socket_path)
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        try:
            c.connect(path)
        except (FileNotFoundError, ConnectionRefusedError) as e:
            print(
                f"[ERROR orion_kmer_tpu] Error: no server at {path}: {e}",
                file=stderr or sys.stderr,
            )
            return 1
        c.sendall(json.dumps({"argv": [str(a) for a in argv]}).encode() + b"\n")
        chunks = []
        while True:
            data = c.recv(1 << 16)
            if not data:
                break
            chunks.append(data)
    finally:
        c.close()
    line = b"".join(chunks).split(b"\n", 1)[0]
    if not line:
        print(
            f"[ERROR orion_kmer_tpu] Error: empty reply from server at {path}",
            file=stderr or sys.stderr,
        )
        return 1
    rep = json.loads(line)
    (stdout or sys.stdout).write(rep["stdout"])
    (stderr or sys.stderr).write(rep["stderr"])
    return int(rep["rc"])


def run_serve(args) -> None:
    """Dispatch target for the ``serve`` subcommand."""
    serve(args.socket)
