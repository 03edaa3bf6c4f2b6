"""The typed failures the serving scheduler raises (copied from
``repro/serving/faults.py``; fault injection itself is not ported yet)."""


class ExecutorCrash(RuntimeError):
    """A replica's executor died on a non-request fault."""
