"""``macroc_tpu_torch/parallel/launch.py::spawn_local``: N local ranks of
one process group, each reporting a ``RANK`` JSON line; a failing rank
fails the launch and no process outlives it."""

import json
import os
import time

import pytest

from macroc_tpu_torch.parallel.launch import spawn_local

# a rank: its MACROC_* environment and, with a process group, one
# all-reduce over the ranks (gloo on the CPU)
ENV_PROGRAM = r"""
import json, os, sys
import torch
from macroc_tpu_torch.parallel import distributed
started = distributed.maybe_initialize()
t = distributed.Comm("cpu").sum(torch.ones(1))
print("RANK " + json.dumps(dict(
    arg=sys.argv[1], started=started, ranks=int(t.item()),
    env={k: os.environ.get(k) for k in ("MACROC_COORDINATOR", "MACROC_NUM_PROCESSES",
                                       "MACROC_PROCESS_ID", "MACROC_PLATFORM")})))
distributed.shutdown()
"""

# rank 1 fails at once; the others write their pid and wait far longer
# than the test
FAIL_PROGRAM = r"""
import os, sys, time
rank = int(os.environ["MACROC_PROCESS_ID"])
with open(os.path.join(sys.argv[1], f"pid_{rank}"), "w") as f:
    f.write(str(os.getpid()))
if rank == 1:
    print("rank 1 fails on purpose", flush=True)
    sys.exit(3)
time.sleep(600)
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("n", [1, 3])
def test_ranks_get_the_process_group_environment(n):
    records = spawn_local(ENV_PROGRAM, "hello", n, env={"MACROC_PLATFORM": "cpu"})
    assert len(records) == n
    for rank, r in enumerate(records):
        assert r["arg"] == "hello" and r["ranks"] == n and r["started"] == (n > 1)
        assert r["env"]["MACROC_PLATFORM"] == "cpu"
        if n == 1:
            assert r["env"] == dict(MACROC_COORDINATOR=None, MACROC_NUM_PROCESSES=None,
                                    MACROC_PROCESS_ID=None, MACROC_PLATFORM="cpu")
        else:
            assert r["env"]["MACROC_COORDINATOR"].startswith("localhost:")
            assert (r["env"]["MACROC_NUM_PROCESSES"], r["env"]["MACROC_PROCESS_ID"]) == (
                str(n), str(rank))


def test_a_failing_rank_fails_the_launch_and_stops_every_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 3 exited 3:[\s\S]*fails on purpose"):
        spawn_local(FAIL_PROGRAM, str(tmp_path), 3, timeout=120)
    assert time.monotonic() - t0 < 60
    pids = [int((tmp_path / f"pid_{r}").read_text()) for r in range(3)]
    assert not any(_alive(pid) for pid in pids)


def test_a_rank_past_the_timeout_is_stopped(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 of 1 timed out after 3 s"):
        spawn_local("import os, sys, time\n"
                    "open(os.path.join(sys.argv[1], 'pid'), 'w').write(str(os.getpid()))\n"
                    "time.sleep(600)\n", str(tmp_path), 1, timeout=3)
    assert not _alive(int((tmp_path / "pid").read_text()))


def test_a_rank_without_a_record_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 0 of 1 printed no RANK line"):
        spawn_local("print('no record')", "", 1)
    assert spawn_local("print('RANK ' + '{\"a\": 1}')", "", 1) == [json.loads('{"a": 1}')]


@pytest.mark.parametrize("script", ["tune_microfe_torch", "_pancake_mg_check_torch",
                                    "bisect_newton_torch", "scaling_sweep_torch"])
def test_scripts_want_the_card_by_default(monkeypatch, tmp_path, script):
    """Without MACROC_PLATFORM each script wants the card and raises
    without one; nothing falls back to the CPU."""
    import torch

    import _torch_scripts_common as common

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    monkeypatch.delenv("MACROC_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.load_script(script).main(["--out", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()


@pytest.mark.parametrize("fail", [False, True])
def test_guarded_reports_a_failure_and_goes_on(capsys, fail):
    """``guarded``: the result of a call that returns; for one that raises,
    None, its name among the failures and a FAILED line printed."""
    from macroc_tpu_torch.utils.profiling import guarded

    def fn():
        if fail:
            raise ValueError("made to fail")
        return {"ok": 1}

    failures = ["earlier"]
    r = guarded("cfg", fn, failures)
    printed = capsys.readouterr()
    assert r == (None if fail else {"ok": 1})
    assert failures == (["earlier", "cfg"] if fail else ["earlier"])
    assert ("cfg: FAILED: made to fail" in printed.out) == fail
    assert ("ValueError" in printed.err) == fail


@pytest.mark.parametrize("failures", [[], ["a", "b"]])
def test_finish_writes_the_record_and_prints_the_headline_last(capsys, tmp_path, failures):
    """``finish``: the record with the device, the versions and the
    failures in the JSON file (its folder made), the headline with the
    failures, the device and the path as the last line printed, and exit
    code 1 exactly when something failed."""
    import torch

    from macroc_tpu_torch.utils.profiling import finish

    out = tmp_path / "new" / "out.json"
    print("before")
    code = finish(str(out), dict(rows={"x": 1.5}), dict(best="x"), failures, "cpu")
    record = json.loads(out.read_text())
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert code == int(bool(failures))
    assert record == dict(rows={"x": 1.5}, device="cpu", torch=torch.__version__,
                          cuda=torch.version.cuda, failures=failures)
    assert last == dict(best="x", failures=failures, device="cpu", out=str(out))
