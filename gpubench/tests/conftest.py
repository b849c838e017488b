import signal

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
    config.addinivalue_line("markers", "time_limit(seconds): the test fails past this wall time")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    """A test marked ``time_limit(s)`` raises ``TimeoutError`` after s seconds."""
    mark = item.get_closest_marker("time_limit")
    if mark is None:
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"{item.nodeid} ran past its {mark.args[0]} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(int(mark.args[0]))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
