"""The suite's own harness: the `slow` marker that `-m 'not slow'` drops,
strict marker registration (pytest.ini), and the per-test backstop of
tests/conftest.py.  Each test runs pytest in a subprocess with a bounded
timeout, below the backstop's limit."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

from .conftest import REPO_ROOT

# Well below tests/conftest.py's TEST_LIMIT_S, so a stuck child fails here
# with its own output instead of taking the worker down.
CHILD_TIMEOUT_S = 180


def _pytest(*args: str, **env: str):
    # A child run is a pytest run of its own, not part of this worker.
    child_env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_XDIST_")}
    child_env.update(env)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *args],
        cwd=REPO_ROOT,
        env=child_env,
        capture_output=True,
        text=True,
        timeout=CHILD_TIMEOUT_S,
    )
    return proc.returncode, proc.stdout + proc.stderr


def test_not_slow_drops_the_at_scale_error_lanes():
    rc, out = _pytest(
        "--collect-only", "-q", "-n", "0", "-m", "not slow",
        "tests/test_batch_pipeline.py",
    )
    assert rc == 0, out[-2000:]
    assert "tests/test_batch_pipeline.py::" in out, out[-2000:]
    assert "TestAtScaleErrorLanes" not in out, out[-2000:]


def test_every_marker_in_tests_is_registered():
    rc, out = _pytest("--collect-only", "-q", "-n", "0", "--strict-markers", "tests/")
    assert rc == 0, out[-2000:]


def test_backstop_fails_a_hung_test_and_the_run_ends(tmp_path):
    (tmp_path / "test_hang.py").write_text(
        textwrap.dedent(
            """
            import time

            def test_before():
                pass

            def test_hangs():
                time.sleep(120)

            def test_after():
                pass
            """
        )
    )
    rc, out = _pytest(
        "-q", "-n", "1", "--dist", "load", "-p", "tests.conftest",
        "--rootdir", str(tmp_path), "-c", str(REPO_ROOT / "pytest.ini"),
        str(tmp_path / "test_hang.py"),
        KZG_TEST_LIMIT_S="3",
    )
    assert rc == 1, out[-3000:]
    assert "Timeout (0:00:03)!" in out, out[-3000:]
    assert "crashed while running" in out and "test_hangs" in out, out[-3000:]
    assert "1 failed, 2 passed" in out, out[-3000:]
