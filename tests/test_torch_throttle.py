"""The port's token bucket (``batch_scheduler_tpu_torch/utils/throttle.py``)
against the JAX package's (``tests/test_throttle.py`` mirrored): the same
acquisitions on the same injected clock wait exactly the same seconds
and hand out exactly the same tokens in both packages; and the HTTP
clientset's request verbs stay capped at burst + qps*t against the
gateway in both packages."""

import importlib
import threading
import time

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _bucket(pkg, **kwargs):
    return importlib.import_module(f"{pkg}.utils.throttle").TokenBucket(**kwargs)


def _burst_then_qps(pkg):
    now = [0.0]
    waits = []

    def sleep(s):
        waits.append(s)
        now[0] += s

    tb = _bucket(pkg, qps=10.0, burst=5, clock=lambda: now[0], sleep=sleep)
    for _ in range(25):
        tb.acquire()
    return waits, now[0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_bucket_burst_then_qps(pkg):
    """Deterministic (injected clock): burst tokens go instantly, then the
    bucket paces to exactly qps — and every wait equals the reference's."""
    waits, now = _burst_then_qps(pkg)
    assert abs(sum(waits) - 20 * 0.1) < 1e-6, sum(waits)
    assert now >= 2.0 - 1e-6
    assert (waits, now) == _burst_then_qps(PACKAGES[0])


def _refill_trace(pkg):
    now = [0.0]
    tb = _bucket(pkg, qps=10.0, burst=3, clock=lambda: now[0], sleep=lambda s: None)
    got = [tb.try_acquire() for _ in range(4)]
    now[0] += 100.0  # long idle: refill caps at burst, not qps*t
    got += [tb.try_acquire() for _ in range(4)]
    now[0] += 0.15  # one and a half tokens' worth
    got += [tb.try_acquire() for _ in range(2)]
    return got


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_bucket_refills_while_idle_and_caps_at_burst(pkg):
    got = _refill_trace(pkg)
    assert got[:4] == [True, True, True, False]
    assert got[4:8] == [True, True, True, False]
    assert got == _refill_trace(PACKAGES[0])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_token_bucket_disabled(pkg):
    def never(_s):
        raise AssertionError("a disabled bucket never sleeps")

    tb = _bucket(pkg, qps=0, burst=0, sleep=never)
    for _ in range(100):
        tb.acquire()
        assert tb.try_acquire()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("qps,burst", [(10.0, 0), (0.5, -1)])
def test_token_bucket_rejects_unfillable_burst(pkg, qps, burst):
    with pytest.raises(ValueError):
        _bucket(pkg, qps=qps, burst=burst)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_http_clientset_capped_under_resync_load(pkg):
    """Many concurrent request verbs through the HTTP client cannot exceed
    burst + qps*t against the gateway (20 qps / burst 5: 5 at once, 15
    paced, at least 0.75 s; unthrottled this burst takes well under 0.2 s)."""
    apiserver = importlib.import_module(f"{pkg}.client.apiserver")
    http = importlib.import_module(f"{pkg}.client.http_apiserver")
    gateway = importlib.import_module(f"{pkg}.client.http_gateway")
    backing = apiserver.APIServer()
    server = gateway.serve_gateway(backing)
    api = http.HTTPAPIServer(*server.server_address[:2], qps=20.0, burst=5)
    try:
        backing.create("PodGroup", {"metadata": {"name": "g", "namespace": "default"}})
        t0 = time.monotonic()
        threads = [threading.Thread(target=lambda: api.get("PodGroup", "default", "g"))
                   for _ in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert time.monotonic() - t0 >= 0.6
    finally:
        api.close()
        server.shutdown()
        server.server_close()
