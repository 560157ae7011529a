"""The port's runtime sanitizers, on the CPU (mirror of
``tests/analysis/test_sanitizers.py``, case for case).

Recompilation guard: the counter is fed by the port's own build hooks: an
``nvcc`` build of ``kernels/build.py`` (a stand-in compiler script, since
this machine has no ``nvcc``), a ``g++`` build of ``utils/native.py`` (the
real compiler), and a Triton specialisation launched through the norm
wrappers' ``_launch`` (a stand-in JIT object that, like Triton, returns
its cached compiled object on a repeat and a new one for a new
constexpr).  Lock order: cycles within and across threads, a consistent
order, a condition wait, untracked locks when disabled.  Block ledger: a
hand-built engine shape, where the JAX package's ``LedgerSanitizer`` must
reach the same verdict, message for message, and the same leak report.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from megatron_llm_tpu.analysis import sanitizers as jsan
from megatron_llm_tpu_torch.analysis import sanitizers
from megatron_llm_tpu_torch.analysis.sanitizers import (
    CompileCounter,
    LedgerError,
    LedgerSanitizer,
    LockOrderError,
    RecompilationError,
    TrackedLock,
    no_recompiles,
)
from megatron_llm_tpu_torch.kernels import build
from megatron_llm_tpu_torch.kernels import rmsnorm
from megatron_llm_tpu_torch.utils import native

# -- recompilation guard ----------------------------------------------------

FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


@pytest.fixture
def fake_kernel_tree(tmp_path, monkeypatch):
    """A source directory with one ``.cu``, a build directory, and an
    ``nvcc`` that writes an empty library: what ``build_all`` needs to
    run its real code path here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    return csrc


class FakeJIT:
    """Triton's launch contract: ``kernel[grid](*args, **constexprs)``
    returns the compiled object, the same one for a cached
    specialisation."""

    __name__ = "fake_kernel"

    def __init__(self):
        self.cache = {}

    def __getitem__(self, grid):
        def launch(*args, **kw):
            key = tuple(sorted(kw.items()))
            return self.cache.setdefault(key, object())
        return launch


def test_compile_counter_sees_fresh_compile_and_not_cache_hits(
        fake_kernel_tree):
    with CompileCounter() as warm:
        build.build_all(names=("fake",))
    assert warm.count == 1 and warm.compiled == ["nvcc:fake"]
    with CompileCounter() as cached:
        build.build_all(names=("fake",))  # the library is current
    assert cached.count == 0


def test_compile_counter_sees_native_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_libs", {})
    src = tmp_path / "helper.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    with CompileCounter() as warm:
        lib = native.compile_and_load(src)
    assert lib.answer() == 42
    assert warm.compiled == ["g++:helper.cpp"]
    with CompileCounter() as cached:
        native.compile_and_load(src)
    assert cached.count == 0


def test_no_recompiles_raises_on_new_specialisation():
    kernel = FakeJIT()
    rmsnorm._launch(kernel, (4,), 1, BLOCK=64)  # warm-up
    with no_recompiles():
        rmsnorm._launch(kernel, (8,), 2, BLOCK=64)  # cached: fine
    with pytest.raises(RecompilationError, match="triton:fake_kernel"):
        with no_recompiles():
            rmsnorm._launch(kernel, (4,), 1, BLOCK=128)  # a new constexpr


def test_no_recompiles_allowance():
    kernel = FakeJIT()
    with no_recompiles(allow=1) as counter:
        rmsnorm._launch(kernel, (4,), 1, BLOCK=32)  # one compile permitted
    assert counter.count == 1


# -- lock-order checker -----------------------------------------------------


@pytest.fixture
def lock_tracking():
    sanitizers.enable_lock_tracking()
    sanitizers.reset_lock_tracking()
    yield
    sanitizers.reset_lock_tracking()


def test_lock_order_cycle_detected(lock_tracking):
    a, b = TrackedLock("A"), TrackedLock("B")
    with a:
        with b:
            pass
    assert sanitizers.lock_order_violations() == []
    with b:
        with a:  # inverts the recorded A -> B order
            pass
    violations = sanitizers.lock_order_violations()
    assert violations and "A" in violations[0] and "B" in violations[0]
    with pytest.raises(LockOrderError):
        sanitizers.check_lock_order()


def test_lock_order_cycle_detected_across_threads(lock_tracking):
    a, b = TrackedLock("T-A"), TrackedLock("T-B")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert sanitizers.lock_order_violations()


def test_consistent_order_is_clean(lock_tracking):
    a, b = TrackedLock("C-A"), TrackedLock("C-B")
    for _ in range(3):
        with a:
            with b:
                pass
    sanitizers.check_lock_order()


def test_condition_wait_produces_no_violation(lock_tracking):
    cond = sanitizers.make_condition("cond")
    with cond:
        cond.wait(timeout=0.01)
    sanitizers.check_lock_order()


def test_make_lock_untracked_when_disabled(monkeypatch):
    monkeypatch.setattr(sanitizers, "_tracking_enabled", False)
    assert not isinstance(sanitizers.make_lock("plain"), TrackedLock)


# -- block-pool ledger --------------------------------------------------------


def _fake_engine(n_blocks=8, num_slots=2, table_blocks=4):
    """The engine shape the ledger sanitizer walks: one occupied slot
    owning blocks 1 and 2, everything else free."""
    ref = np.zeros(n_blocks, np.int32)
    ref[0] = ref[1] = ref[2] = 1  # trash, permanently pinned, and 1, 2
    pool = SimpleNamespace(
        TRASH=0, n_blocks=n_blocks, _ref=ref,
        _free=[b for b in range(n_blocks - 1, 0, -1) if b not in (1, 2)],
        _reserved=0)
    tables = np.zeros((num_slots, table_blocks), np.int32)
    tables[0, 0], tables[0, 1] = 1, 2
    slots = SimpleNamespace(pool=pool, num_slots=num_slots, tables=tables,
                            reserved=np.zeros(num_slots, np.int64),
                            _free=[1])
    return SimpleNamespace(
        slots=slots, _active={0: SimpleNamespace(
            req=SimpleNamespace(rid="req-7"))},
        _prefilling=None, prefix_cache=None)


def _verdicts(mutate, checks=1, pre_check=False):
    """The port's and JAX's sanitizer on identical fake engines: their
    error messages (None when clean) and leak reports, which must agree."""
    out = []
    for mod in (sanitizers, jsan):
        engine = _fake_engine()
        san = mod.LedgerSanitizer()
        if pre_check:
            san.check_engine(engine)
        mutate(engine)
        msg = None
        try:
            for _ in range(checks):
                san.check_engine(engine)
        except AssertionError as e:
            msg = str(e)
        out.append((msg, san.leak_report(engine)))
    assert out[0] == out[1]
    return out[0]


def test_ledger_clean_state_passes():
    engine = _fake_engine()
    san = LedgerSanitizer()
    san.check_engine(engine)
    assert san.checks == 1
    assert san.owners[1] == ["req-7"]
    assert san.leak_report(engine) == []
    assert _verdicts(lambda e: None) == (None, [])


def test_ledger_reports_leak_with_owner():
    engine = _fake_engine()
    san = LedgerSanitizer()
    san.check_engine(engine)  # records block 2's owner
    engine.slots.tables[0, 1] = 0  # the table forgets block 2, ref stays 1
    with pytest.raises(LedgerError, match=r"block 2 .*leaked"):
        san.check_engine(engine)
    (leak,) = san.leak_report(engine)
    assert leak == {"block": 2, "ref": 1, "accounted": 0,
                    "last_owners": ["req-7"]}

    def forget(e):
        e.slots.tables[0, 1] = 0

    msg, report = _verdicts(forget, pre_check=True)
    assert "leaked" in msg and report == [leak]


def test_ledger_detects_use_after_free_hazard():
    def drop(e):
        e.slots.pool._ref[2] = 0
        e.slots.pool._free.append(2)

    msg, _ = _verdicts(drop)
    assert "use-after-free" in msg
    engine = _fake_engine()
    drop(engine)
    with pytest.raises(LedgerError, match="use-after-free"):
        LedgerSanitizer().check_engine(engine)


def test_ledger_detects_double_free():
    def double(e):
        e.slots.pool._free.append(e.slots.pool._free[0])

    msg, _ = _verdicts(double)
    assert "double free" in msg
    engine = _fake_engine()
    double(engine)
    with pytest.raises(LedgerError, match="double free"):
        LedgerSanitizer().check_engine(engine)


def test_ledger_detects_reservation_drift():
    def drift(e):
        e.slots.pool._reserved = 3  # nothing in slots.reserved backs it

    msg, _ = _verdicts(drift)
    assert "reservation" in msg
    engine = _fake_engine()
    drift(engine)
    with pytest.raises(LedgerError, match="reservation"):
        LedgerSanitizer().check_engine(engine)
