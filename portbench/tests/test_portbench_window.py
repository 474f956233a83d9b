"""The window's end-to-end metrics count a stalled job inside the window,
and not the read-backs of the outputs the check samples."""

import time

from portbench import harness

PAUSE = 0.05
STALL = 0.4


def _loop(stall_at=None, keep=lambda i, last: last):
    import torch

    out = (torch.full((1, 2), 2**31 - 1, dtype=torch.int32),
           torch.zeros((1, 2), dtype=torch.int32), torch.tensor(0))
    count = {"n": 0}

    def call(i):
        time.sleep(STALL if count["n"] == stall_at else PAUSE)
        count["n"] += 1
        return out

    return harness.closed_loop(call, 1, 1.0, "cpu", keep)


def test_a_stalled_job_counts_in_the_rate_and_the_tail():
    calm = _loop()
    stalled = _loop(stall_at=3)
    assert max(stalled.walls) >= STALL
    n = 1 << 20
    m_calm = harness.end_to_end(calm, n, 0.0)
    m_stall = harness.end_to_end(stalled, n, 0.0)
    # the stall's time stays in the window: fewer jobs in about as long
    assert stalled.seconds >= 1.0 and len(stalled.walls) < len(calm.walls)
    assert m_stall["tokens_per_s"] < m_calm["tokens_per_s"]
    assert m_stall["tokens_per_s"] == n * len(stalled.walls) / stalled.seconds
    # the tail holds the stall when it is more than 5 % of the jobs' time
    assert m_stall["job_ms_p95"] > m_calm["job_ms_p95"]
    # every job's wall lies inside the window, the last one's fence ends it
    assert sum(stalled.walls) <= stalled.seconds + 1e-6


def test_the_last_job_is_read_back():
    w = _loop()
    assert [i for i, _, _ in w.outputs] == [len(w.walls) - 1]


def test_read_backs_are_not_window_time(monkeypatch):
    read = harness.read_output

    def slow(out):
        time.sleep(PAUSE)
        return read(out)

    monkeypatch.setattr(harness, "read_output", slow)
    w = _loop(keep=lambda i, last: True)
    # every job but the last is read back inside the window, in as long as
    # a job takes, and none of it is counted
    assert len(w.outputs) == len(w.walls)
    assert w.readback >= (len(w.walls) - 1) * PAUSE
    assert w.seconds < w.end - w.begin - (len(w.walls) - 1) * PAUSE + 1e-9
    assert sum(w.walls) <= w.seconds + 1e-6
    assert harness.end_to_end(w, 100, 0.0)["tokens_per_s"] == 100 * len(w.walls) / w.seconds
