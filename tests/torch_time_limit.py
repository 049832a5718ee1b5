"""The per-test time limit of the port's wire and HA tests.

pytest-timeout is not a dependency, so the ``timeout`` marker is
enforced here by SIGALRM: a test module imports :func:`_time_limit`,
which makes it an autouse fixture of that module, and a hung server or
replica then fails its own test instead of stalling the run.
"""

import signal

import pytest


@pytest.fixture(autouse=True)
def _time_limit(request):
    """The test's own time limit (its ``timeout`` marker, else 120 s)."""
    mark = request.node.get_closest_marker("timeout")
    limit = int(mark.args[0]) if mark else 120

    def fire(signum, frame):
        raise TimeoutError(f"test exceeded its {limit}s time limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
