"""The port's ring buffer (runtime/ring_buffer.py over utils/native.py) and
chunk tracker (runtime/tracker.py) against the JAX package's: the same
push, wraparound and overflow sequences give the same samples, positions
and capacities (the numpy ring and the native SPSC ring, each against the
reference's of the same backend); the same pending and result events give
the same ready lists, dedup and backpressure decisions. Exact: host code,
fp32 samples copied."""

import shutil

import numpy as np
import pytest

from openhush_tpu.runtime import ring_buffer as jax_ring
from openhush_tpu.runtime import tracker as jax_tracker
from openhush_tpu.utils import native as jax_native
from openhush_tpu_torch.runtime import ring_buffer, tracker
from openhush_tpu_torch.utils import native

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler for the native ring")


def _rings(native_backend: bool, secs: float):
    return (jax_ring.RingBuffer(duration_secs=secs,
                                prefer_native=native_backend),
            ring_buffer.RingBuffer(duration_secs=secs,
                                   prefer_native=native_backend))


def _script(seed: int, cap: int, n_ops: int = 200):
    """A random op sequence: pushes of 1..cap/2 samples, some far larger
    than the ring (overflow), and extracts from marks old and new (spans
    past the capacity wrap)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        n = (int(rng.integers(cap + 1, 3 * cap)) if rng.random() < 0.05
             else int(rng.integers(1, cap // 2)))
        ops.append(("push", rng.standard_normal(n).astype(np.float32)))
        if rng.random() < 0.3:
            ops.append(("mark", None))
        ops.append(("extract", float(rng.random())))
    return ops


def _replay(rb, ops):
    out, marks = [], [0]
    for op, arg in ops:
        if op == "push":
            rb.push(arg)
        elif op == "mark":
            marks.append(rb.mark().position)
        else:
            start = marks[int(arg * len(marks))]
            now = rb.current_position()
            out.append((start, now, rb.extract_range(start, now)))
    return out, rb.capacity, rb.current_position()


@pytest.mark.parametrize("native_backend", [
    False, pytest.param(True, marks=needs_gxx)], ids=["numpy", "native"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ring_matches_reference(native_backend, seed):
    ref, port = _rings(native_backend, 0.02)          # 512 samples
    assert port.is_native == ref.is_native == native_backend
    ops = _script(seed, ref.capacity)
    (a, cap_a, pos_a), (b, cap_b, pos_b) = _replay(ref, ops), _replay(port,
                                                                      ops)
    assert (cap_b, pos_b) == (cap_a, pos_a) and len(b) == len(a)
    for (s0, n0, x0), (s1, n1, x1) in zip(a, b):
        assert (s1, n1) == (s0, n0)
        np.testing.assert_array_equal(x1, x0)
    # Some extracts wrapped past the capacity: the newest samples come back.
    assert any(n - s > cap_a for s, n, _ in a)


@pytest.mark.parametrize("native_backend", [
    False, pytest.param(True, marks=needs_gxx)], ids=["numpy", "native"])
def test_ring_edges_match_reference(native_backend):
    """Power-of-two capacity, an empty and an inverted range, a push
    larger than the ring, extract_since a mark."""
    for rb in _rings(native_backend, 0.1):
        assert rb.capacity == 2048
        rb.push(np.arange(500, dtype=np.float32))
        np.testing.assert_array_equal(rb.extract_range(100, 200),
                                      np.arange(100, 200, dtype=np.float32))
        assert len(rb.extract_range(200, 200)) == 0
        assert len(rb.extract_range(300, 200)) == 0
        m = rb.mark()
        big = np.arange(5000, dtype=np.float32)
        rb.push(big)
        np.testing.assert_array_equal(rb.extract_since(m), big[-2048:])
        assert rb.duration_secs() == 2048 / 16000


@needs_gxx
def test_native_ring_builds_outside_the_source_tree():
    """The port compiles native/openhush_native.cpp into its own build
    directory and never writes into native/."""
    lib = native.load()
    assert lib is not None
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert "openhush_tpu_torch" in str(so)
    ring = native.NativeRing(1000)
    assert ring.capacity == jax_native.NativeRing(1000).capacity == 1024


# ---------- tracker ----------

def _events(seed: int):
    """A random sequence over three sessions: pending (with one of the
    three strategies) and results whose texts overlap their predecessors'
    tails, interleaved with take_ready and reset_dedup."""
    rng = np.random.default_rng(seed)
    words = "the quick brown fox jumps over lazy dog and then some".split()
    ev = []
    for seq in range(3):
        for chunk in range(int(rng.integers(3, 9))):
            strat = ["drop_oldest", "drop_newest", "warn"][
                int(rng.integers(0, 3))]
            ev.append(("pending", seq, chunk, strat,
                       int(rng.integers(0, 6))))
        for chunk in rng.permutation(int(rng.integers(2, 9))):
            start = int(rng.integers(0, len(words) - 3))
            text = " ".join(words[start:start + int(rng.integers(1, 8))])
            ev.append(("result", seq, int(chunk), text,
                       bool(rng.random() < 0.2)))
            if rng.random() < 0.4:
                ev.append(("take",))
        ev.append(("take",))
        if rng.random() < 0.5:
            ev.append(("reset",))
    return ev


def _run_tracker(mod, events, streaming):
    t = mod.TranscriptionTracker(streaming=streaming)
    out = []
    for e in events:
        if e[0] == "pending":
            _, seq, chunk, strat, cap = e
            out.append(("accepted", t.add_pending(seq, chunk, max_pending=cap,
                                                  strategy=strat),
                        sorted(t._pending), t.pending_count))
        elif e[0] == "result":
            _, seq, chunk, text, final = e
            t.add_result(mod.ChunkResult(text=text, sequence_id=seq,
                                         chunk_id=chunk, is_final=final,
                                         duration_secs=1.0))
        elif e[0] == "take":
            out.append(("ready", [(r.sequence_id, r.chunk_id, r.text,
                                   r.is_final) for r in t.take_ready()]))
        else:
            t.reset_dedup()
        out.append(("stats", t.pending_count, t.waiting_count,
                    t.is_empty()))
    return out


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "ordered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_matches_reference(streaming, seed):
    events = _events(seed)
    ref = _run_tracker(jax_tracker, events, streaming)
    port = _run_tracker(tracker, events, streaming)
    assert port == ref
    if streaming and seed == 0:
        # The sequence exercised dedup and a rejection.
        assert any(e[0] == "accepted" and not e[1] for e in port)


def test_tracker_backpressure_and_dedup_cases():
    """The three strategies at capacity and the dedup rule, on both."""
    for mod in (jax_tracker, tracker):
        t = mod.TranscriptionTracker()
        for i in range(10):
            assert t.add_pending(0, i, max_pending=10, strategy="drop_newest")
        assert not t.add_pending(0, 10, max_pending=10,
                                 strategy="drop_newest")
        assert t.add_pending(0, 10, max_pending=10, strategy="drop_oldest")
        assert (0, 0) not in t._pending and t.pending_count == 10
        assert t.add_pending(0, 11, max_pending=10, strategy="warn")
        assert t.pending_count == 11
        t.add_result(mod.ChunkResult("the quick brown fox jumps", 0, 0,
                                     False, 1.0))
        t.take_ready()
        t.add_result(mod.ChunkResult("fox jumps over the lazy dog", 0, 1,
                                     False, 1.0))
        assert t.take_ready()[0].text == "over the lazy dog"
