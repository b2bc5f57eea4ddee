"""``chip_smoke.py``'s lane of command lines (``CliLane``, ``run_command``,
``stop_commands``): its jobs run one after another on a thread beside the
caller, a job's error is raised where its result is read, and a command the
lane still runs is ended on request. Plain Python subprocesses on the CPU."""

import sys
import time

import pytest


def _python(code: str) -> list:
    return [sys.executable, "-c", code]


def test_lane_runs_its_jobs_in_order_beside_the_caller():
    import chip_smoke

    order = []

    def job(name, code):
        def run():
            order.append(name)
            return chip_smoke.run_command(_python(code), 60).stdout.strip()
        return run

    t0 = time.perf_counter()
    lane = chip_smoke.CliLane({"a": job("a", "import time; time.sleep(0.5); print('a')"),
                               "b": job("b", "print('b')")})
    assert time.perf_counter() - t0 < 0.5  # the caller goes on while the lane works
    assert lane.result("a") == "a" and lane.result("b") == "b"
    assert order == ["a", "b"] and set(lane.seconds) == {"a", "b"}
    assert lane.wall_s >= lane.seconds["a"] >= 0.5
    assert not chip_smoke._LIVE


def test_lane_raises_a_jobs_error_where_its_result_is_read():
    import chip_smoke

    def fails():
        raise ValueError("the job's own message")

    lane = chip_smoke.CliLane({"fails": fails, "after": lambda: 7,
                               "late": lambda: chip_smoke.run_command(_python("import time; time.sleep(30)"), 0.5)})
    assert lane.result("after") == 7  # an earlier job's failure does not stop the lane
    with pytest.raises(AssertionError, match="fails job failed: ValueError: the job's own message"):
        lane.result("fails")
    with pytest.raises(AssertionError, match="late job failed: TimeoutExpired"):
        lane.result("late")
    assert not chip_smoke._LIVE  # the timed-out command was ended


def test_stop_ends_the_command_the_lane_runs():
    import chip_smoke

    lane = chip_smoke.CliLane({"long": lambda: chip_smoke.run_command(_python("import time; time.sleep(120)"), 600)})
    deadline = time.monotonic() + 30
    while not chip_smoke._LIVE and time.monotonic() < deadline:
        time.sleep(0.01)
    assert chip_smoke._LIVE
    t0 = time.perf_counter()
    lane.stop()
    assert time.perf_counter() - t0 < 30 and not chip_smoke._LIVE
    assert lane.result("long").returncode != 0  # ended by a signal, not run to its end
