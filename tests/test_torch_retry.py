"""The port's retry primitives (batch_scheduler_tpu_torch/utils/retry.py)
against the JAX package's: the same backoff draws from the same seeded rng,
the same retry chains under ``call``, and the same circuit-breaker state
sequences under a fake clock."""

import random

import pytest

from batch_scheduler_tpu.utils import retry as jretry
from batch_scheduler_tpu_torch.utils import retry as tretry

POLICIES = (
    {},
    {"max_attempts": 6, "base_delay": 0.01, "max_delay": 0.5, "multiplier": 3.0},
    {"max_attempts": 2, "base_delay": 0.2, "max_delay": 0.25},
)


@pytest.mark.parametrize("kwargs", POLICIES)
@pytest.mark.parametrize("seed", (0, 7))
def test_backoff_draws_match_reference(kwargs, seed):
    port, ref = tretry.RetryPolicy(**kwargs), jretry.RetryPolicy(**kwargs)
    rng_p, rng_r = random.Random(seed), random.Random(seed)
    prev_p = prev_r = None
    for i in range(12):
        # full jitter (stateless draws) and the decorrelated chain
        assert port.backoff(i, rng=rng_p) == ref.backoff(i, rng=rng_r)
        prev_p = port.backoff(i, rng=rng_p, prev=prev_p)
        prev_r = ref.backoff(i, rng=rng_r, prev=prev_r)
        assert prev_p == prev_r
        assert 0.0 <= prev_p <= port.max_delay


@pytest.mark.parametrize("fail_times", (0, 2, 10))
def test_call_retry_chain_matches_reference(fail_times):
    def run(mod):
        random.seed(11)  # call() draws from the module rng
        calls, slept, retried = [0], [], []

        def fn():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise ConnectionError(f"attempt {calls[0]}")
            return "ok"

        policy = mod.RetryPolicy(max_attempts=4, base_delay=0.05)
        try:
            out = policy.call(
                fn, retry_on=(ConnectionError,), sleep=slept.append,
                on_retry=lambda i, e, d: retried.append((i, str(e), d)),
            )
        except ConnectionError as e:
            out = f"raised {e}"
        return out, calls[0], slept, retried

    assert run(tretry) == run(jretry)


def test_call_no_retry_wins_like_reference():
    for mod in (tretry, jretry):
        calls = []

        def fn():
            calls.append(1)
            raise KeyError("semantic")

        with pytest.raises(KeyError):
            mod.RetryPolicy().call(fn, retry_on=(Exception,), no_retry=(KeyError,),
                                   sleep=lambda d: None)
        assert len(calls) == 1


def _breaker_trace(mod, script):
    """Drive one breaker through ``script`` (op, clock advance) under a
    fake clock; returns every observable after each step."""
    now = [100.0]
    transitions = []
    breaker = mod.CircuitBreaker(
        failure_threshold=3, reset_timeout=5.0, clock=lambda: now[0],
        on_transition=transitions.append,
    )
    trace = []
    for op, advance in script:
        now[0] += advance
        out = None
        if op == "admit":
            out = breaker.admit()
        elif op == "fail":
            breaker.record_failure()
        elif op == "ok":
            breaker.record_success()
        trace.append((op, out, breaker.state, breaker.would_attempt()))
    return trace, transitions


def test_circuit_breaker_sequences_match_reference():
    rng = random.Random(5)
    ops = ("admit", "fail", "ok")
    scripts = [
        # closed -> open at the threshold -> refuse in cooldown -> half-open
        # probe -> failed probe re-opens -> cooldown -> probe -> closed
        [("fail", 0), ("fail", 1), ("admit", 0), ("fail", 0), ("admit", 1),
         ("admit", 4.5), ("fail", 0), ("admit", 2), ("admit", 5), ("ok", 0),
         ("admit", 0)],
    ]
    for _ in range(20):
        scripts.append([(rng.choice(ops), rng.choice((0, 0.5, 2.5, 6.0)))
                        for _ in range(30)])
    for script in scripts:
        assert _breaker_trace(tretry, script) == _breaker_trace(jretry, script)
