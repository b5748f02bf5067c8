"""Shared helper of the port's tests: send this process's stdout and stderr
at the file-descriptor level into a temporary file, so that output which
bypasses sys.stdout (spawned ranks, which inherit the descriptors, or the
profiler's native logging) stays off pytest's progress line."""

import contextlib
import os
import sys
import tempfile


@contextlib.contextmanager
def fds_to_file():
    """Redirect fds 1 and 2 into a temporary file for the block; yields the
    file, for a failure's report."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with tempfile.TemporaryFile("w+") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        try:
            yield log
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            for fd in saved:
                os.close(fd)
