import pytest

from benchmark.harness.window import Window


def run(window, chunk, dt, caps=None, start=0.0):
    t, steps, i = start, 0, 0
    while True:
        t += dt(i) if callable(dt) else dt
        steps += chunk
        cap = caps(i) if caps else 0
        if window.boundary(t, steps, at_cap=cap):
            return t
        i += 1


@pytest.mark.parametrize("chunk,dt,seconds", [(1, 0.058, 10.0), (24, 10.8, 50.0),
                                              (32, 1.5, 45.0), (24, 11.3, 45.0)])
def test_window_holds_whole_chunks_and_never_passes_the_seconds(chunk, dt, seconds):
    w = Window(seconds, warm_steps=chunk)
    run(w, chunk, dt)
    assert w.steps % chunk == 0 and w.steps > 0
    assert w.wall <= seconds + 1e-9
    # one more interval would have passed the seconds
    assert w.wall + dt > seconds
    assert w.step_seconds == pytest.approx(dt / chunk)


def test_window_opens_after_the_warm_up():
    w = Window(5.0, warm_steps=32)
    run(w, 1, 0.13)
    assert w.steps_open == 32 and w.steps == 38


def test_window_counts_failed_steps_from_the_cap_counter_and_never_more_than_its_steps():
    w = Window(10.0, warm_steps=4)
    # boundaries after 4 warm steps; then chunks of 4 with 0, 1, 9, 0, ... passes at cap
    run(w, 4, 1.0, caps=lambda i: {2: 1, 3: 9}.get(i, 0))
    assert w.steps == 4 * 10
    assert w.failed == 1 + 4


def test_window_with_a_jittered_pace_stays_inside():
    times = [1.0, 1.0, 1.2, 0.9, 1.3, 1.0, 1.1, 1.25, 0.95, 1.0, 1.0, 1.0, 1.0, 1.0]
    w = Window(6.0, warm_steps=1)
    run(w, 1, lambda i: times[i])
    assert w.wall <= 6.0


def test_window_refuses_an_interval_longer_than_itself():
    w = Window(5.0, warm_steps=1)
    w.boundary(0.0, 1)
    with pytest.raises(RuntimeError):
        w.boundary(6.0, 2)
