"""``ops/build.library()`` under concurrent first callers (the server's
batcher threads): one build and one load a process, every caller handed the
same library. ``build`` and ``ctypes.CDLL`` are replaced by counters, so no
compiler runs."""

import ctypes
import threading
import time
import types

from deepfakedetection_tpu_torch.ops import build


class _FakeLibrary:
    """Hands out a fresh attribute holder for every entry point looked up."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_library_builds_and_loads_once_under_eight_first_callers(monkeypatch, tmp_path):
    builds, loads = [], []

    def slow_build():
        builds.append(threading.current_thread().name)
        time.sleep(0.2)  # a long build window for the other callers to race into
        return tmp_path / "libdfd_kernels_test.so"

    def cdll(path):
        loads.append(path)
        return _FakeLibrary()

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(build, "_loaded", None)
    start = threading.Barrier(8)
    got = [None] * 8

    def first_call(i):
        start.wait(timeout=10)
        got[i] = build.library()

    threads = [threading.Thread(target=first_call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == [str(tmp_path / "libdfd_kernels_test.so")]
    assert got[0] is not None and all(lib is got[0] for lib in got)
    assert got[0].dfd_attn4d.restype is ctypes.c_int  # signatures set on the one load
    assert build.library() is got[0] and len(builds) == 1
