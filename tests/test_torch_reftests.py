"""The reference's fullstack-test corpus through the port's SQL front end
(counterpart of ``tests/test_reftests.py``, ``_mpp``, ``_issues``,
``_aux`` and ``_mpp_distributed``).

Each ``.test`` file of ``expr``, ``mpp``, ``issues``, ``fault-inject`` and
``system-table`` runs through ``tiflash_tpu_torch.testing.reftest.
run_test_file(path, device="cpu")``.  A file the manifests
(``tests/reftest_*_manifest.json``, read, never written) mark ``pass``
must verify at least its recorded ``checked`` floor and exactly as many
queries as the reference's ``run_test_file`` verifies on the same file; a
``fail`` file must fail as the reference's does (a mismatch or the same
crash); an ``unsupported`` one must raise ``Unsupported``.  The
fault-inject and system-table files hold their floors, and the MPP subset
runs again with ``TIFLASH_REFTEST_DISTRIBUTED=1`` over ``cpu_mesh(8)``
with its distributed-run floors.  Every test skips where the corpus is
absent, as the reference's do.
"""

import glob
import json
import os
import pathlib

import pytest

import test_reftests
import test_reftests_aux
import test_reftests_mpp_distributed

from tiflash_tpu_torch.runtime.failpoint import FailPoint

HERE = pathlib.Path(__file__).parent
ROOT = os.path.dirname(test_reftests.CORPUS)       # .../fullstack-test
MANIFESTS = {"expr": "reftest_manifest.json", "mpp": "reftest_mpp_manifest.json",
             "issues": "reftest_issues_manifest.json"}
FILES = [(d, os.path.basename(p)) for d in MANIFESTS
         for p in sorted(glob.glob(f"{ROOT}/{d}/*.test"))]


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    from tiflash_tpu.runtime.failpoint import FailPoint as JFailPoint

    FailPoint.disable_all()
    JFailPoint.disable_all()


def _outcome(run, path):
    """(checked, None) or (None, the exception's kind) of one run."""
    try:
        return run(path), None
    except AssertionError:
        return None, "mismatch"
    except Exception as e:
        return None, f"crash:{type(e).__name__}"


@pytest.mark.skipif(not os.path.isdir(ROOT), reason="reference corpus not present")
@pytest.mark.parametrize("directory,fname", FILES, ids=[f"{d}/{f}" for d, f in FILES])
def test_corpus_file(directory, fname):
    from tiflash_tpu.testing import reftest as JR
    from tiflash_tpu_torch.testing import reftest as TR

    manifest = json.loads((HERE / MANIFESTS[directory]).read_text())
    entry = manifest.get(fname, {"status": "pass"})
    path = f"{ROOT}/{directory}/{fname}"
    port = _outcome(lambda p: TR.run_test_file(p, device="cpu"), path)
    ref = _outcome(JR.run_test_file, path)
    if entry["status"] == "unsupported":
        assert port[1] == "crash:Unsupported", port
        return
    if entry["status"] == "fail":
        assert port == ref, (fname, port, ref)
        return
    assert port[1] is None, (fname, port)
    assert port[0] >= entry.get("checked", 1 if entry["status"] == "pass" else 0), port
    assert port == ref, (fname, port, ref)


@pytest.mark.parametrize("rel,floor", test_reftests_aux.CASES,
                         ids=[c[0] for c in test_reftests_aux.CASES])
def test_aux_corpus_file(rel, floor):
    path = f"{ROOT}/{rel}"
    if not os.path.exists(path):
        pytest.skip("reference corpus not present")
    from tiflash_tpu_torch.testing.reftest import run_test_file

    assert run_test_file(path, device="cpu") >= floor


@pytest.mark.parametrize("fname,floor,dist_floor", test_reftests_mpp_distributed.CASES,
                         ids=[c[0] for c in test_reftests_mpp_distributed.CASES])
def test_mpp_file_distributed(fname, floor, dist_floor, monkeypatch):
    path = f"{ROOT}/mpp/{fname}"
    if not os.path.exists(path):
        pytest.skip("reference corpus not present")
    from tiflash_tpu_torch.testing.reftest import (RefTestSession, parse_test_file,
                                                   tests_root_of)

    monkeypatch.setenv("TIFLASH_REFTEST_DISTRIBUTED", "1")
    sess = RefTestSession(device="cpu", tests_root=tests_root_of(path))
    for stmt, expected in parse_test_file(path):
        sess.run_statement(stmt, expected)
    assert sess.checked >= floor, (fname, sess.checked)
    assert sess.distributed_runs >= dist_floor, (fname, sess.distributed_runs)
