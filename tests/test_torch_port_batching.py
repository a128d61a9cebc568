"""The port's request micro-batching (serving/batching.py) against the JAX
package's module: the ladder and the auto rule on a grid, the batcher's
semantics, one scripted arrival order through both batchers, and the
calibration on a host whose per-dispatch overhead dominates.

Every wait has a bound: ``search(timeout=...)``, ``Event.wait(timeout)``,
``join(timeout=...)``.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from image_search_engine_tpu.serving import batching as jax_batching
from image_search_engine_tpu_torch.serving import batching

WAIT_S = 30.0  # the bound on every wait below; none is reached when the code is right


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("max_batch", [1, 2, 8, 16])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 8, 16])
def test_pad_to_ladder_matches_jax(n, max_batch):
    assert batching.pad_to_ladder(n, max_batch) == jax_batching.pad_to_ladder(n, max_batch)


@pytest.mark.parametrize("threaded_ms,batched_ms", [
    (10.0, 5.0), (10.0, 9.5), (10.0, 9.0), (10.0, 8.999), (5.0, 10.0), (0.0, 0.0), (1.0, 0.9)])
@pytest.mark.parametrize("margin", [0.9, 0.5, 1.0])
def test_micro_batch_pays_matches_jax(threaded_ms, batched_ms, margin):
    assert (batching.micro_batch_pays(threaded_ms, batched_ms, margin)
            == jax_batching.micro_batch_pays(threaded_ms, batched_ms, margin))
    if margin == 0.9:  # the default margin
        assert (batching.micro_batch_pays(threaded_ms, batched_ms)
                == jax_batching.micro_batch_pays(threaded_ms, batched_ms))


def _fake_search(images, k):
    """Each row's own result: its first pixel value, then 1 .. k-1 after it."""
    tag = images[:, 0, 0, 0].astype(np.float64)
    d = tag[:, None] + np.arange(k)[None, :]
    return d, (tag[:, None] * 100 + np.arange(k)[None, :]).astype(np.int32)


def _image(v: float) -> np.ndarray:
    return np.full((4, 4, 3), v, np.float32)


def test_batcher_batches_and_returns_each_rider_its_own_result():
    sizes = []

    def fn(images, k):
        sizes.append(images.shape[0])
        return _fake_search(images, k)

    mb = batching.MicroBatcher(fn, max_batch=8, max_wait_ms=WAIT_S * 1e3)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(mb.search, _image(i + 1), 3, WAIT_S) for i in range(8)]
            results = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        mb.close()
    assert sizes == [8]  # 8 riders fill one batch, which runs without waiting out max_wait
    for i, (d, ids) in enumerate(results):
        np.testing.assert_array_equal(d, [[i + 1, i + 2, i + 3]])
        np.testing.assert_array_equal(ids, [[(i + 1) * 100, (i + 1) * 100 + 1,
                                             (i + 1) * 100 + 2]])


def test_batcher_keeps_a_lone_request_at_batch_one():
    sizes = []

    def fn(images, k):
        sizes.append(images.shape[0])
        return _fake_search(images, k)

    mb = batching.MicroBatcher(fn, max_batch=8, max_wait_ms=1.0)
    try:
        d, ids = mb.search(_image(7), 2, timeout=WAIT_S)
    finally:
        mb.close()
    assert sizes == [1]
    np.testing.assert_array_equal(d, [[7, 8]])


def test_batcher_propagates_an_error_to_every_rider():
    entered, gate = threading.Event(), threading.Event()
    calls = []

    def fn(images, k):
        calls.append(images.shape[0])
        if len(calls) == 1:  # hold the first batch until the others queue
            entered.set()
            gate.wait(WAIT_S)
            return _fake_search(images, k)
        raise RuntimeError("boom")

    mb = batching.MicroBatcher(fn, max_batch=4, max_wait_ms=0.0)
    try:
        with ThreadPoolExecutor(4) as pool:
            first = pool.submit(mb.search, _image(1), 2, WAIT_S)
            assert entered.wait(WAIT_S)
            riders = [pool.submit(mb.search, _image(i), 2, WAIT_S) for i in (2, 3, 4)]
            _wait_queued(mb, 3)
            gate.set()
            first.result(timeout=WAIT_S)
            for r in riders:
                with pytest.raises(RuntimeError, match="boom"):
                    r.result(timeout=WAIT_S)
    finally:
        mb.close()
    assert calls == [1, 4]  # the three riders failed together, in one padded batch


def test_batcher_runs_mixed_k_at_the_largest_and_slices_each():
    seen_k = []

    def fn(images, k):
        seen_k.append(k)
        return _fake_search(images, k)

    entered, gate = threading.Event(), threading.Event()

    def gated(images, k):
        if not entered.is_set():
            entered.set()
            gate.wait(WAIT_S)
        return fn(images, k)

    mb = batching.MicroBatcher(gated, max_batch=4, max_wait_ms=0.0)
    try:
        with ThreadPoolExecutor(4) as pool:
            first = pool.submit(mb.search, _image(1), 1, WAIT_S)
            assert entered.wait(WAIT_S)
            riders = [pool.submit(mb.search, _image(v), k, WAIT_S)
                      for v, k in ((2, 5), (3, 2), (4, 3))]
            _wait_queued(mb, 3)
            gate.set()
            first.result(timeout=WAIT_S)
            got = [r.result(timeout=WAIT_S) for r in riders]
    finally:
        mb.close()
    assert seen_k == [1, 5]
    for (v, k), (d, ids) in zip(((2, 5), (3, 2), (4, 3)), got):
        assert d.shape == ids.shape == (1, k)
        np.testing.assert_array_equal(d[0], v + np.arange(k))


def test_batcher_close_ends_its_thread():
    mb = batching.MicroBatcher(_fake_search, max_batch=4, max_wait_ms=1.0)
    assert mb._worker.is_alive()
    mb.search(_image(1), 1, timeout=WAIT_S)
    mb.close()
    assert not mb._worker.is_alive()


def test_batcher_search_times_out():
    release = threading.Event()

    def stuck(images, k):
        release.wait(WAIT_S)
        return _fake_search(images, k)

    mb = batching.MicroBatcher(stuck, max_batch=2, max_wait_ms=0.0)
    try:
        with pytest.raises(TimeoutError):
            mb.search(_image(1), 1, timeout=0.05)
    finally:
        release.set()
        mb.close()
    assert not mb._worker.is_alive()


def _wait_queued(mb, n: int) -> None:
    """Until ``n`` requests sit in the batcher's queue (bounded)."""
    deadline = time.monotonic() + WAIT_S
    while mb._q.qsize() < n:
        assert time.monotonic() < deadline, "requests did not reach the queue"
        time.sleep(0.001)


def _scripted_run(module):
    """One arrival order, held gate by gate: A alone; then B..F queued while
    A's batch runs (max_batch 4: B..E, then F alone). Returns the padded
    batch sizes, the k of each batch and each rider's result."""
    gates = [threading.Event() for _ in range(3)]
    entered = [threading.Event() for _ in range(3)]
    calls = []

    def fn(images, k):
        i = len(calls)
        calls.append((images.shape[0], k))
        entered[i].set()
        assert gates[i].wait(WAIT_S)
        return _fake_search(images, k)

    mb = module.MicroBatcher(fn, max_batch=4, max_wait_ms=0.0)
    ks = {"A": 2, "B": 3, "C": 1, "D": 4, "E": 2, "F": 5}
    try:
        with ThreadPoolExecutor(6) as pool:
            futs = {"A": pool.submit(mb.search, _image(1), ks["A"], WAIT_S)}
            assert entered[0].wait(WAIT_S)
            for j, name in enumerate("BCDEF"):
                futs[name] = pool.submit(mb.search, _image(j + 2), ks[name], WAIT_S)
                _wait_queued(mb, j + 1)  # arrival order B, C, D, E, F
            gates[0].set()
            assert entered[1].wait(WAIT_S)
            gates[1].set()
            assert entered[2].wait(WAIT_S)
            gates[2].set()
            results = {n: f.result(timeout=WAIT_S) for n, f in futs.items()}
    finally:
        mb.close()
    assert not mb._worker.is_alive()
    return calls, results


def test_scripted_arrivals_form_the_jax_batches():
    got_calls, got = _scripted_run(batching)
    want_calls, want = _scripted_run(jax_batching)
    assert got_calls == want_calls == [(1, 2), (4, 4), (1, 5)]
    for name in "ABCDEF":
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_calibration_detects_an_overhead_bound_host():
    """A host whose dispatches serialize on the device thread with a large
    fixed cost each: B = 1 requests each pay it, one padded batch pays it
    once, so the rule batches (the JAX package's test of the same name,
    tests/test_observability.py, with the port's device thread in place of
    its lock)."""
    fixed_s, per_row_s = 0.020, 0.001

    def search(images, k):
        time.sleep(fixed_s + per_row_s * images.shape[0])
        b = images.shape[0]
        return np.zeros((b, k)), np.zeros((b, k), np.int32)

    device_thread = ThreadPoolExecutor(max_workers=1)
    try:
        def on_device(images, k):
            return device_thread.submit(search, images, k).result(timeout=WAIT_S)

        threaded_ms, batched_ms = batching.measure_micro_batch_gain(
            on_device, image_shape=(4, 4, 3), k=3, max_batch=4, reps=2)
    finally:
        device_thread.shutdown(wait=True)
    # threaded ~ fixed + per_row = 21 ms a query; batched ~ (20 + 4) / 4 = 6 ms
    assert batched_ms < threaded_ms
    assert batching.micro_batch_pays(threaded_ms, batched_ms)


def test_calibration_reraises_a_failing_dispatch():
    def search(images, k):
        if images.shape[0] == 1 and threading.current_thread() is not threading.main_thread():
            raise RuntimeError("b1 failed")
        return np.zeros((images.shape[0], k)), np.zeros((images.shape[0], k), np.int32)

    with pytest.raises(RuntimeError, match="b1 failed"):
        batching.measure_micro_batch_gain(search, (4, 4, 3), k=2, max_batch=3, reps=1)
