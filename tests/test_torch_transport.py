"""The port's fleet transport and host agent against the JAX package's.

The wire is the JAX package's, byte for byte: the hello and the length
prefix, and the frames of payloads made of Python primitives (whose
pickles name no class of either package).  Both packages' framing fails
the same way on strangers, version skew, truncation, oversized headers
and disconnects; ``parse_addr`` and the coordinator's guard rails agree.
One test starts real ``python -m repro_torch.fleet.agent`` processes on
the CPU: a listening agent replays profiles dialled through
``emulate_many`` bit-identical to the in-process replay and to the
JAX package's totals, and a dial-in agent asked for ``"cuda"`` on a host
without a card fails its init with the worker's traceback.
"""
import os
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

import repro.core as R
import repro.scenarios as RS
import repro_torch.core as T
import repro_torch.fleet as TF
import repro_torch.scenarios as TS
from repro.fleet import RemoteFleet as RRemoteFleet
from repro.fleet import WorkerSpec as RWorkerSpec
from repro.fleet.transport import framing as rframing
from repro.fleet.transport.remote import parse_addr as r_parse_addr
from repro_torch.fleet.transport import framing as tframing
from repro_torch.fleet.transport.remote import parse_addr as t_parse_addr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FRAMING = {"torch": tframing, "jax": rframing}
TILE = 64
BLOCK = 1 << 18


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _wire(framing, send):
    """The bytes ``send(sock)`` puts on the wire."""
    a, b = _pair()
    try:
        send(a)
        a.close()
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out += chunk
    finally:
        b.close()


PAYLOADS = [
    None, 0, -7, 2 ** 40, 0.1 + 0.2, float("inf"), "stop", b"\x00\xff",
    ("stop",), ("ping",), ("run", 3, 7, {"payload": list(range(100))}),
    ("retry", 1, 4, "agent-local worker died"),
    ("ready", {"workers": 2, "host": "h", "agent_pid": 1}),
    {"nested": [1, 2.5, ("a", None)], "flag": True}, [], {},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=repr)
def test_frames_are_byte_identical(payload):
    wires = {pkg: _wire(f, lambda s, f=f: f.send_frame(s, payload))
             for pkg, f in FRAMING.items()}
    assert wires["torch"] == wires["jax"]
    n = struct.unpack(">I", wires["torch"][:4])[0]
    assert n == len(wires["torch"]) - 4


def test_hello_and_constants_are_the_references():
    assert (tframing.MAGIC, tframing.VERSION, tframing.MAX_FRAME_BYTES) == \
        (rframing.MAGIC, rframing.VERSION, rframing.MAX_FRAME_BYTES)
    hellos = {pkg: _wire(f, f.send_hello) for pkg, f in FRAMING.items()}
    assert hellos["torch"] == hellos["jax"] == \
        struct.pack(">4sHH", b"SYNF", 1, 0)


@pytest.mark.parametrize("sender,receiver", [("torch", "jax"),
                                             ("jax", "torch")])
def test_handshake_and_frames_cross_packages(sender, receiver):
    a, b = _pair()
    t = threading.Thread(target=FRAMING[sender].handshake, args=(a,))
    t.start()
    FRAMING[receiver].handshake(b)
    t.join(10.0)
    msg = ("run", 3, 7, {"payload": list(range(100))})
    FRAMING[sender].send_frame(a, msg)
    assert FRAMING[receiver].recv_frame(b) == msg
    a.close()
    b.close()


@pytest.mark.parametrize("pkg", sorted(FRAMING))
def test_hello_rejects_wrong_magic_and_version(pkg):
    framing = FRAMING[pkg]
    a, b = _pair()
    a.sendall(b"HTTP/1.1 200 OK\r\n")           # not a fleet endpoint
    with pytest.raises(framing.FramingError, match="magic"):
        framing.recv_hello(b)
    c, d = _pair()
    c.sendall(struct.pack(">4sHH", framing.MAGIC, framing.VERSION + 9, 0))
    with pytest.raises(framing.VersionMismatch, match="v10"):
        framing.recv_hello(d)
    for s in (a, b, c, d):
        s.close()


@pytest.mark.parametrize("pkg", sorted(FRAMING))
def test_truncated_header_and_payload_fail_loudly(pkg):
    framing = FRAMING[pkg]
    a, b = _pair()
    a.sendall(b"\x00\x00")                      # 2 of 4 header bytes
    a.close()
    with pytest.raises(framing.FramingError, match="mid-frame header"):
        framing.recv_frame(b)
    b.close()
    a, b = _pair()
    a.sendall(struct.pack(">I", 1000) + b"x" * 10)   # announce 1000, send 10
    a.close()
    with pytest.raises(framing.FramingError, match="10 of 1000"):
        framing.recv_frame(b)
    b.close()


@pytest.mark.parametrize("pkg", sorted(FRAMING))
def test_oversize_rejected_both_ways(pkg):
    framing = FRAMING[pkg]
    a, b = _pair()
    a.sendall(struct.pack(">I", framing.MAX_FRAME_BYTES + 1))
    with pytest.raises(framing.FramingError, match="corrupt stream"):
        framing.recv_frame(b)
    with pytest.raises(framing.FramingError, match="refusing to send"):
        framing.send_frame(a, b"x" * (framing.MAX_FRAME_BYTES + 1))
    a.close()
    b.close()


@pytest.mark.parametrize("pkg", sorted(FRAMING))
def test_disconnects_are_typed_not_a_hang(pkg):
    framing = FRAMING[pkg]
    a, b = _pair()
    a.close()                                   # clean EOF between frames
    with pytest.raises(framing.TransportClosed):
        framing.recv_frame(b)
    b.close()
    c, d = _pair()
    c.sendall(struct.pack(">I", 1 << 20))       # header only, then vanish
    errs = []

    def reader():
        try:
            framing.recv_frame(d)
        except framing.TransportError as e:
            errs.append(e)

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)
    c.close()
    t.join(timeout=5.0)
    assert not t.is_alive(), "recv_frame hung on a dead peer"
    assert len(errs) == 1 and isinstance(errs[0], framing.FramingError)
    d.close()
    # a corrupt-but-well-framed payload is a FramingError, not a raw
    # unpickling error
    e, f = _pair()
    framing.send_frame(e, ("ok", 1), _mangle=lambda p: b"\x00" * len(p))
    with pytest.raises(framing.FramingError, match="unpickle"):
        framing.recv_frame(f)
    e.close()
    f.close()


@pytest.mark.parametrize("text", ["10.0.0.1:9000", "9000", "host:0",
                                  "[::1]:80", ":7", "no-port", "h:x"])
def test_parse_addr_equals_reference(text):
    def call(fn):
        try:
            return fn(text)
        except ValueError as e:
            return ("ValueError", str(e))
    assert call(t_parse_addr) == call(r_parse_addr)


def _em(pkg, **kw):
    core = {"torch": T, "jax": R}[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return core.Emulator(calib=core.HostCalibration(1e9, 1e9, 1e8, 1e8),
                         compute_tile=TILE, mem_block=BLOCK, **extra, **kw)


def test_remote_guard_rails_equal_reference():
    specs = {"torch": TF.WorkerSpec(emulator=_em("torch").spec(),
                                    device="cpu"),
             "jax": RWorkerSpec(emulator=_em("jax").spec())}
    fleets = {"torch": TF.RemoteFleet, "jax": RRemoteFleet}
    for kw in ({}, {"agents": 2}, {"listen": "127.0.0.1:0",
                                   "min_workers": 1}):
        msgs = []
        for pkg in ("torch", "jax"):
            with pytest.raises(ValueError) as e:
                fleets[pkg](specs[pkg], **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # a listening fleet binds port 0 to a free port and closes it again
    with TF.RemoteFleet(specs["torch"], listen="127.0.0.1:0") as f:
        host, port = f.bound_addr
        assert host == "127.0.0.1" and port > 0
    # meshes need the collective atom in the port
    mesh = TF.MeshSpec(shape=(2,), axes=("model",))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TF.RemoteFleet(TF.WorkerSpec(emulator=specs["torch"].emulator,
                                     mesh=mesh, device="cpu"),
                       listen="127.0.0.1:0")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TF.run_remote_fleet(_em("torch"), [], hosts=["h:1"],
                            mesh_spec=mesh)
    # the kernel backend ships no compiled tables: remote refuses it too
    with pytest.raises(ValueError, match="fused torch replay"):
        _em("torch", backend="cuda").emulate_many(
            [], config=TF.FleetConfig.remote(["h:1"]))


# ---------------------------------------------------------------------------
# real agents on the CPU (spawns the agent and its workers)
# ---------------------------------------------------------------------------

@pytest.fixture
def agent_env(monkeypatch):
    """Agents find the package through PYTHONPATH, and their spawned CPU
    workers run torch on one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    old = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + old if old
                                             else ""))
    return env


def _agent(env, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fleet.agent", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _read_line(proc, timeout):
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            raise TimeoutError(f"agent printed nothing in {timeout}s")
        return proc.stdout.readline()
    finally:
        sel.close()


def _finish(proc, timeout=60.0):
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=10.0)
        raise


def _jobs(S):
    return [S.generate("fanout_straggler", n_workers=3, work_flops=5e7,
                       work_hbm=4e7, jitter=0.0, seed=7),
            S.generate("retry_storm", n_tasks=4, work_flops=2e7,
                       work_hbm=2e6, seed=2),
            S.generate("mixed_fleet", total_samples=8, seed=1)]


def _dump(rep):
    return {"command": rep.command, "consumed": rep.consumed.to_dict(),
            "n_samples": rep.n_samples, "mode": rep.mode}


def test_agents_on_the_cpu_dial_and_accept(agent_env, tmp_path):
    """Dial mode: a listening agent with 2 workers replays the jobs sent
    through ``emulate_many(config=FleetConfig.remote([addr]))`` bit for
    bit like this process's fused replay, to the JAX package's totals,
    merges its tracks into the trace, and exits 0 on stop.  Accept mode:
    an agent dialling in, asked for ``"cuda"`` where there is none, fails
    its workers' init, and the coordinator raises the worker's
    traceback."""
    r_em, t_em = _em("jax"), _em("torch")
    r_em.storage.dir = t_em.storage.dir = str(tmp_path)
    refs = [r_em.emulate(p, fused=True) for p in _jobs(RS)]
    local = [t_em.emulate(p, fused=True) for p in _jobs(TS)]
    r_em.storage.cleanup()
    t_em.storage.cleanup()

    agent = _agent(agent_env, "--listen", "127.0.0.1:0", "--workers", "2")
    try:
        line = _read_line(agent, 60.0)
        assert "listening on" in line, line
        addr = line.strip().rsplit(" ", 1)[-1]
        out = t_em.emulate_many(_jobs(TS), config=TF.FleetConfig.remote(
            [addr], timeout=120.0))
        out_s, err_s = _finish(agent)
    finally:
        if agent.poll() is None:
            agent.kill()
            agent.communicate(timeout=10.0)
    assert agent.returncode == 0, err_s
    assert "served 3 bundle(s)" in out_s
    assert out.cache_stats == {"agents": 1, "workers": 2,
                               "worker_deaths": 0}
    assert [_dump(r) for r in out.reports] == [_dump(r) for r in local]
    assert [r.consumed.to_dict() for r in out.reports] == \
        [r.consumed.to_dict() for r in refs]
    want = R.ResourceVector()
    for r in refs:
        want = want.add(r.consumed)
    assert out.totals.to_dict() == want.to_dict()
    scopes = {e["scope"] for e in out.obs["events"]}
    assert {"agent", "worker:0", "coordinator"} <= scopes
    from repro_torch.obs import Event, to_chrome_trace, validate_trace
    trace = to_chrome_trace([Event.from_dict(e)
                             for e in out.obs["events"]])
    validate_trace(trace)
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert any(t.startswith("agent") for t in tracks)

    if torch.cuda.is_available():
        return                    # a cuda worker is valid on this host
    fleet = TF.RemoteFleet(TF.WorkerSpec(emulator=t_em.spec(),
                                         device="cuda", warmup=False),
                           listen="127.0.0.1:0", agents=1)
    bad = _agent(agent_env, "--connect",
                 "127.0.0.1:%d" % fleet.bound_addr[1], "--workers", "1")
    try:
        with pytest.raises(RuntimeError, match="CUDA") as e:
            fleet.warmup(timeout=120.0)
        assert "fleet worker failed to initialize" in str(e.value)
        assert "Traceback" in str(e.value)
    finally:
        fleet.close()
        out_s, err_s = _finish(bad)
    assert bad.returncode != 0
    assert "spawning 1 local worker(s) on cuda" in out_s
