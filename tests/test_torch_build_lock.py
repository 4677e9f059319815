"""``ops/cuda/build.py`` builds a new source once when several threads
(the query service's) meet it at once.  The compiler is stubbed, so this
runs on the CPU: a fake ``nvcc`` process counts its starts and writes its
output after a pause long enough for every thread to arrive."""

import threading
import time

from tiflash_tpu_torch.ops.cuda import build


class FakeNvcc:
    started = []

    def __init__(self, cmd, stdout=None, stderr=None, text=None):
        FakeNvcc.started.append(cmd)
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None

    def communicate(self):
        time.sleep(0.3)
        with open(self.out, "w") as f:
            f.write("built")
        self.returncode = 0
        return "", None

    def poll(self):
        return self.returncode

    def kill(self):
        pass

    def wait(self):
        return self.returncode


def test_concurrent_threads_build_a_new_shape_once(monkeypatch, tmp_path):
    FakeNvcc.started = []
    loaded = []
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    text = "// a generated source of one new plan shape\n"
    barrier = threading.Barrier(4)
    libs = []

    def worker():
        barrier.wait()
        libs.append(build.build_generated("stream_tile", text))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(FakeNvcc.started) == 1
    assert len(loaded) == 1 and len(libs) == 4 and len(set(libs)) == 1
    # a second call in this process finds it loaded: no build, no load
    build.build_generated("stream_tile", text)
    assert len(FakeNvcc.started) == 1 and len(loaded) == 1
