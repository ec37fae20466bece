"""PyTorch port, native host library: ``native/build.py`` writes
``libframepack.so`` only whole (g++ into a temporary file, then
``os.replace``), under an ``fcntl.flock`` beside it, so concurrent builds
in several processes compile once and every process loads a whole library.
A library is reused only beside a stamp of the host that built it
(``libframepack.so.host``: the CPU's model name and flags, since g++ builds
it with ``-march=native``); a missing or foreign stamp rebuilds it.

The compiler is faked: it "builds" a copy of a shared object the
interpreter already has (``_ctypes``), in two halves with a pause between,
so a reader of the output path mid-build would see half a file.
"""

import ctypes
import fcntl
import os
import subprocess
import sys
import textwrap
import threading
import time

import _ctypes
import pytest

from vr_video_generator_tpu_torch.native import build as nb

SHARED_OBJECT = _ctypes.__file__  # any shared object ctypes can load


def fake_compile(log_path, pause=0.2):
    """A stand-in for subprocess.run(g++ ...): logs the command, then writes
    SHARED_OBJECT to the ``-o`` target in two halves."""

    def run(cmd, check=True, capture_output=True, **_):
        out = cmd[cmd.index("-o") + 1]
        with open(log_path, "a") as log:
            log.write(" ".join(cmd) + "\n")
        data = open(SHARED_OBJECT, "rb").read()
        with open(out, "wb") as f:
            f.write(data[:len(data) // 2])
            f.flush()
            time.sleep(pause)
            f.write(data[len(data) // 2:])
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    return run


@pytest.fixture
def tmp_lib(tmp_path, monkeypatch):
    """The build module pointed at a source and library under tmp_path."""
    src = tmp_path / "framepack.cpp"
    src.write_text("// source\n")
    monkeypatch.setattr(nb, "_HERE", str(tmp_path))
    monkeypatch.setattr(nb, "_SRC", str(src))
    monkeypatch.setattr(nb, "_SO", str(tmp_path / "libframepack.so"))
    return tmp_path


def compiles(log_path):
    return open(log_path).read().splitlines() if log_path.exists() else []


def test_gpp_never_writes_the_final_library(tmp_lib, monkeypatch):
    log = tmp_lib / "log"
    monkeypatch.setattr(nb.subprocess, "run", fake_compile(log, pause=0.0))
    path = nb.build(force=True)
    (cmd,) = compiles(log)
    target = cmd.split()[cmd.split().index("-o") + 1]
    assert os.path.abspath(target) != os.path.abspath(nb._SO)
    assert os.path.dirname(os.path.abspath(target)) == str(tmp_lib)
    assert path == nb._SO and not os.path.exists(target)
    assert open(path, "rb").read() == open(SHARED_OBJECT, "rb").read()


def test_final_library_appears_only_whole_via_os_replace(tmp_lib, monkeypatch):
    """A watcher polling the library path during the build never finds a
    file that is not the whole library, and the path is made by
    os.replace."""
    whole = open(SHARED_OBJECT, "rb").read()
    monkeypatch.setattr(nb.subprocess, "run",
                        fake_compile(tmp_lib / "log", pause=0.3))
    replaced = []
    real_replace = os.replace

    def replace(src, dst):
        replaced.append((src, dst, open(src, "rb").read() == whole))
        real_replace(src, dst)

    monkeypatch.setattr(nb.os, "replace", replace)
    seen, done = [], threading.Event()

    def watch():
        while not done.is_set():
            if os.path.exists(nb._SO):
                seen.append(open(nb._SO, "rb").read() == whole)
            time.sleep(0.005)

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        nb.build(force=True)
    finally:
        done.set()
        watcher.join()
    onto_lib = [whole_src for _, dst, whole_src in replaced if dst == nb._SO]
    assert onto_lib == [True]
    assert all(seen), "the library path held a partial file"
    assert open(nb._SO, "rb").read() == whole


def test_waits_for_a_held_lock_and_reuses_that_build(tmp_lib, monkeypatch):
    """While another process holds the flock, build() waits; when that
    process has put a fresh library in place, build() returns it without
    compiling."""
    log = tmp_lib / "log"
    monkeypatch.setattr(nb.subprocess, "run", fake_compile(log, pause=0.0))
    result = []
    with open(nb._SO + ".lock", "a") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        t = threading.Thread(target=lambda: result.append(nb.build()))
        t.start()
        time.sleep(0.3)
        assert not result and not compiles(log), "build() did not wait"
        with open(nb._SO, "wb") as f:  # the holder's finished build
            f.write(open(SHARED_OBJECT, "rb").read())
        nb._write_stamp()
        fcntl.flock(held, fcntl.LOCK_UN)
    t.join(timeout=30)
    assert result == [nb._SO] and compiles(log) == []
    ctypes.CDLL(result[0])


def test_stale_library_is_rebuilt(tmp_lib, monkeypatch):
    log = tmp_lib / "log"
    monkeypatch.setattr(nb.subprocess, "run", fake_compile(log, pause=0.0))
    nb.build()
    nb.build()
    assert len(compiles(log)) == 1
    later = os.path.getmtime(nb._SO) + 10
    os.utime(nb._SRC, (later, later))
    nb.build()
    assert len(compiles(log)) == 2


FOREIGN = "model name: Another CPU\nflags: fpu sse2\n"


@pytest.mark.parametrize("stamp", ["foreign", "missing", "matching"])
def test_library_is_reused_only_on_the_host_that_built_it(tmp_lib,
                                                          monkeypatch, stamp):
    """A fresh library beside a stamp of another CPU, or beside none (a
    library copied from another machine, or built before the stamp
    existed), is compiled again, and its stamp then names this host; beside
    this host's stamp it is loaded as it is."""
    log = tmp_lib / "log"
    monkeypatch.setattr(nb.subprocess, "run", fake_compile(log, pause=0.0))
    with open(nb._SO, "wb") as f:  # a whole library, newer than its source
        f.write(open(SHARED_OBJECT, "rb").read())
    stamp_path = tmp_lib / "libframepack.so.host"
    if stamp != "missing":
        stamp_path.write_text(FOREIGN if stamp == "foreign"
                              else nb.host_stamp())
    assert nb.build() == nb._SO
    assert len(compiles(log)) == (stamp != "matching")
    assert stamp_path.read_text() == nb.host_stamp()
    nb.build()
    assert len(compiles(log)) == (stamp != "matching")


def test_host_stamp_names_this_cpu():
    """The stamp holds the CPU's model name and flags, as /proc/cpuinfo
    gives them, and is the same at every call."""
    stamp = nb.host_stamp()
    assert stamp == nb.host_stamp() and stamp.endswith("\n")
    if os.path.exists("/proc/cpuinfo"):
        text = open("/proc/cpuinfo").read()
        flags = next(line.split(":", 1)[1].split() for line in
                     text.splitlines() if line.startswith("flags"))
        assert stamp.startswith("model name: ")
        assert "flags: " + " ".join(flags) in stamp


CHILD = textwrap.dedent("""
    import ctypes, sys, time
    sys.path.insert(0, sys.argv[1])
    from tests.test_torch_native_build import fake_compile
    from vr_video_generator_tpu_torch.native import build as nb
    tmp = sys.argv[2]
    nb._HERE, nb._SRC, nb._SO = tmp, tmp + "/framepack.cpp", tmp + "/libframepack.so"
    nb.subprocess.run = fake_compile(__import__("pathlib").Path(tmp) / "log")
    time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
    path = nb.build()
    ctypes.CDLL(path)
    print("loaded", path)
""")


def test_two_processes_compile_once_and_both_load(tmp_lib):
    """Two processes call build() at the same instant: one compiles, the
    other waits on the lock, and both load the whole library."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, repo,
                               str(tmp_lib), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == f"loaded {tmp_lib}/libframepack.so"
    assert len(compiles(tmp_lib / "log")) == 1
