"""serve mode: resident warm-engine server over a unix socket.

Checks that forwarded requests are byte-identical to fresh-process runs
(same dispatch, same error rendering — main.rs:7-16 semantics preserved
per request), that a bad request cannot kill the server, and that the
--server client flag round-trips rc/stdout/stderr."""

from __future__ import annotations

import io
import json
import socket
import threading

import pytest

from orion_kmer_tpu import server as srv
from orion_kmer_tpu.cli import _extract_server_flag, main as cli_main
from orion_kmer_tpu.version import __version__

from .util import SAMPLE1_FASTA, run_cli, write_file


@pytest.fixture
def running(tmp_path):
    sock = tmp_path / "okt.sock"
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve, args=(sock,), kwargs={"on_ready": ready.set}, daemon=True
    )
    t.start()
    assert ready.wait(30), "server did not come up"
    yield sock
    if t.is_alive():
        srv.forward(sock, ["shutdown"], stdout=io.StringIO(), stderr=io.StringIO())
        t.join(30)


def _fwd(sock, argv):
    out, err = io.StringIO(), io.StringIO()
    rc = srv.forward(sock, argv, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def test_count_via_server_matches_direct(running, tmp_path):
    fa = write_file(tmp_path / "s.fasta", SAMPLE1_FASTA)
    direct, served = tmp_path / "direct.tsv", tmp_path / "served.tsv"
    assert run_cli("count", "-k", 5, "-i", fa, "-o", direct) == 0
    rc, _, _ = _fwd(running, ["count", "-k", "5", "-i", str(fa), "-o", str(served)])
    assert rc == 0
    assert served.read_bytes() == direct.read_bytes()
    # second request on the same resident process (warm-reuse path)
    served2 = tmp_path / "served2.tsv"
    rc, _, _ = _fwd(running, ["count", "-k", "5", "-i", str(fa), "-o", str(served2)])
    assert rc == 0
    assert served2.read_bytes() == direct.read_bytes()


def test_version_stdout_roundtrip(running):
    rc, out, _ = _fwd(running, ["--version"])
    assert rc == 0
    assert __version__ in out


def test_error_rc_and_stderr_roundtrip(running, tmp_path):
    rc, _, err = _fwd(
        running,
        ["count", "-k", "5", "-i", str(tmp_path / "missing.fa"), "-o", str(tmp_path / "o")],
    )
    assert rc == 1
    assert "[ERROR orion_kmer_tpu]" in err


def test_usage_error_rc(running):
    rc, _, err = _fwd(running, ["count", "--no-such-flag"])
    assert rc == 2
    assert "usage" in err.lower() or "error" in err.lower()


def test_bad_request_does_not_kill_server(running):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(str(running))
    c.sendall(b"this is not json\n")
    reply = json.loads(c.recv(1 << 16).split(b"\n", 1)[0])
    c.close()
    assert reply["rc"] == 2
    rc, out, _ = _fwd(running, ["--version"])  # still serving
    assert rc == 0 and __version__ in out


def test_nested_serve_refused(running, tmp_path):
    rc, _, err = _fwd(running, ["serve", "--socket", str(tmp_path / "x.sock")])
    assert rc == 2
    assert "cannot nest serve" in err


def test_client_flag_forwarding(running, tmp_path, capsys):
    fa = write_file(tmp_path / "s.fasta", SAMPLE1_FASTA)
    out = tmp_path / "via_flag.tsv"
    rc = cli_main(["--server", str(running), "count", "-k", "5", "-i", str(fa), "-o", str(out)])
    assert rc == 0 and out.exists()
    rc = cli_main([f"--server={running}", "--version"])
    assert rc == 0
    assert __version__ in capsys.readouterr().out


def test_shutdown_removes_socket(tmp_path):
    sock = tmp_path / "okt.sock"
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve, args=(sock,), kwargs={"on_ready": ready.set}, daemon=True
    )
    t.start()
    assert ready.wait(30)
    rc, _, _ = _fwd(sock, ["shutdown"])
    assert rc == 0
    t.join(30)
    assert not t.is_alive()
    assert not sock.exists()


def test_forward_no_server(tmp_path):
    rc, _, err = _fwd(tmp_path / "nope.sock", ["--version"])
    assert rc == 1
    assert "no server" in err


def test_extract_server_flag():
    assert _extract_server_flag(["--server", "/s", "count", "-k", "5"]) == (
        "/s",
        ["count", "-k", "5"],
    )
    assert _extract_server_flag(["--server=/s", "--version"]) == ("/s", ["--version"])
    assert _extract_server_flag(["count", "-k", "5"]) == (None, ["count", "-k", "5"])
