"""The port's spans and counters (``sbmc_tpu_torch/tracing.py``) on the
CPU: off, a span is one shared no-op; under ``torch.profiler`` spans nest
per thread, counters land in the innermost span, the store is capped, and
the profiler's own events hold the spans. The models, the train step and
the reservoir record their stages and give the same results bit for bit
with tracing on and off. On the CPU a span's device ms is its host ms.

Tolerances: none (counts, names, nesting and bit-identical outputs).
"""

import os
import threading

import numpy as np
import pytest
import torch

from sbmc_tpu_torch import profile, tracing
from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.train.interface import DenoiserInterface
from sbmc_tpu_torch.train.reservoir import DeviceReservoir

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(n_features=8, n_global_features=3, width=8, embedding_width=8,
             ksize=3, nsteps=2)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _profiled(fn):
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, prof


def _names(calls):
    return [c.name for c in calls]


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("a"), tracing.span("b", torch.device("cpu"))
    assert a is b
    with a:
        tracing.count("n", 5)
        with tracing.span("inner"):
            pass
    assert tracing.calls() == [] and tracing.calls("a") == []


def test_on_only_while_the_profiler_records():
    def fn():
        assert tracing.enabled()
        with tracing.span("x"):
            pass
    _profiled(fn)
    assert not tracing.enabled()
    with tracing.span("y"):
        pass
    assert _names(tracing.calls()) == ["x"]


def test_nested_spans_keep_their_parents():
    def fn():
        with tracing.span("outer", "cpu"):
            with tracing.span("mid"):
                with tracing.span("leaf"):
                    pass
                with tracing.span("leaf"):
                    pass
            with tracing.span("other"):
                pass
        with tracing.span("second"):
            pass
    _profiled(fn)
    top = tracing.calls()
    assert _names(top) == ["outer", "second"]
    outer = top[0]
    assert _names(outer.children) == ["mid", "other"]
    assert _names(outer.children[0].children) == ["leaf", "leaf"]
    assert _names(outer.walk()) == ["outer", "mid", "leaf", "leaf", "other"]
    assert outer.below["leaf"].calls == 2 and set(outer.below) == {
        "mid", "leaf", "other"}
    for c in outer.walk():
        assert c.device_ms == c.host_ms >= 0
    assert outer.host_ms >= sum(c.host_ms for c in outer.children)
    assert outer.below["leaf"].host_ms == pytest.approx(
        sum(c.host_ms for c in outer.children[0].children))


def test_threads_keep_separate_stacks():
    """A span opened on another thread while the main thread's span is
    open is a top-level call of its own, with its own children."""
    opened, done = threading.Event(), threading.Event()

    def worker():
        opened.wait(30)
        with tracing.span("thread.outer"):
            with tracing.span("thread.inner"):
                pass
        done.set()

    def fn():
        t = threading.Thread(target=worker)
        t.start()
        with tracing.span("main.outer"):
            opened.set()
            assert done.wait(30)
            with tracing.span("main.inner"):
                pass
        t.join(30)
        assert not t.is_alive()
    _profiled(fn)
    top = {c.name: c for c in tracing.calls()}
    assert set(top) == {"main.outer", "thread.outer"}
    assert _names(top["main.outer"].children) == ["main.inner"]
    assert _names(top["thread.outer"].children) == ["thread.inner"]


def test_counters_land_in_the_innermost_span():
    def fn():
        with tracing.span("outer"):
            tracing.count("n")
            with tracing.span("a"):
                tracing.count("n", 2)
                tracing.count("bytes", 100)
            with tracing.span("b"):
                tracing.count("n", 4)
        tracing.count("n", 1000)  # no span open: counted nowhere
    _profiled(fn)
    outer, = tracing.calls()
    a, b = outer.children
    assert a.counters == {"n": 2, "bytes": 100} and b.counters == {"n": 4}
    # A call's counters are its own and its descendants'.
    assert outer.counters == {"n": 7, "bytes": 100}
    assert outer.below["a"].counters == {"n": 2, "bytes": 100}


def test_calls_finds_any_depth_and_reset_empties():
    def fn():
        for _ in range(2):
            with tracing.span("top"):
                with tracing.span("x"):
                    with tracing.span("x.deep"):
                        pass
        with tracing.span("x.deep"):
            pass
    _profiled(fn)
    assert len(tracing.calls("top")) == 2
    assert len(tracing.calls("x.deep")) == 3
    assert tracing.calls("missing") == []
    assert _names(tracing.calls()) == ["top", "top", "x.deep"]
    # Reading twice gives the same records.
    assert tracing.calls("top")[0] is tracing.calls("top")[0]
    tracing.reset()
    assert tracing.calls() == [] and tracing.calls("top") == []


def test_store_drops_the_oldest_calls_past_its_cap(monkeypatch):
    monkeypatch.setattr(tracing._STORE, "_cap", 3)

    def fn():
        for i in range(5):
            with tracing.span("call.%d" % i):
                with tracing.span("child"):
                    pass
    _profiled(fn)
    assert _names(tracing.calls()) == ["call.2", "call.3", "call.4"]
    assert len(tracing.calls("child")) == 3


def test_profiler_events_hold_the_spans_nested_in_time():
    def fn():
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(8).sum()
    _, prof = _profiled(fn)
    events = {e.name: e.time_range for e in prof.events()
              if e.name in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    assert events["outer"].start <= events["inner"].start
    assert events["inner"].end <= events["outer"].end


def _sbmc_inputs(rng, spp=3, h=12, w=14):
    return {"radiance": torch.tensor(rng.rand(1, spp, 3, h, w),
                                     dtype=torch.float32),
            "features": torch.tensor(rng.rand(1, spp, 8, h, w),
                                     dtype=torch.float32),
            "global_features": torch.tensor(rng.rand(1, 3, 1, 1),
                                            dtype=torch.float32),
            "sample_mask": torch.tensor([[True, True, False]])}


def _kpcn_inputs(rng, h=14, w=13):
    x = {k: torch.tensor(rng.rand(1, 27, h, w), dtype=torch.float32)
         for k in ("kpcn_diffuse_in", "kpcn_specular_in")}
    x.update({k: torch.tensor(rng.rand(1, 3, h, w), dtype=torch.float32)
              for k in ("kpcn_diffuse_buffer", "kpcn_specular_buffer",
                        "kpcn_albedo")})
    return x


@pytest.mark.parametrize("model", ["sbmc", "gather", "kpcn"])
def test_models_record_their_stages_and_give_the_same_outputs(model):
    rng = np.random.RandomState(3)
    torch.manual_seed(0)
    if model == "kpcn":
        net = KPCN(ksize=3, depth=2, width=8).eval()
        x = _kpcn_inputs(rng)
        unit, want = "kpcn.forward", {"kpcn.diffuse": 1, "kpcn.specular": 1,
                                      "kpcn.apply": 1}
    else:
        net = Multisteps(**SMALL, splat=model == "sbmc").eval()
        x = _sbmc_inputs(rng)
        unit, want = "sbmc.forward", {"sbmc.embedding": 2,
                                      "sbmc.propagation": 2,
                                      "sbmc.regress": 3, "sbmc.splat": 3}
    with torch.inference_mode():
        off = net(x)
        on, _ = _profiled(lambda: net(x))
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    call, = tracing.calls()
    assert call.name == unit
    assert {n: s.calls for n, s in call.below.items()} == want
    # Every stage is a child of the call, in the order the model runs them.
    assert len(call.children) == sum(want.values())
    if model != "kpcn":
        assert _names(call.children[:4]) == [
            "sbmc.embedding", "sbmc.propagation"] * 2
        assert _names(call.children[4:6]) == ["sbmc.regress", "sbmc.splat"]
    # The models count nothing.
    assert call.counters == {}


def _items(rng, n, spp=3, h=12, w=12):
    return [{"features": rng.rand(spp, 8, h, w).astype(np.float16),
             "radiance": rng.rand(spp, 3, h, w).astype(np.float32),
             "global_features": rng.rand(3, 1, 1).astype(np.float32),
             "target_image": rng.rand(3, h, w).astype(np.float32)}
            for _ in range(n)]


def _reservoir(items):
    torch.manual_seed(1)
    iface = DenoiserInterface(Multisteps(**SMALL), lr=1e-2, device="cpu")
    res = DeviceReservoir(iface, capacity=len(items), batch_size=2, seed=4)
    res.fill(items)
    return iface, res


def test_reservoir_step_records_the_draw_then_the_step_and_its_phases():
    items = _items(np.random.RandomState(5), 4)
    off_iface, off_res = _reservoir(items)
    off = [float(off_res.train_step()["loss"]) for _ in range(2)]
    on_iface, on_res = _profiled(lambda: _reservoir(items))[0]

    def steps():
        return [float(on_res.train_step()["loss"]) for _ in range(2)]
    on, _ = _profiled(steps)
    assert on == off
    for p, q in zip(off_iface.model.parameters(),
                    on_iface.model.parameters()):
        assert torch.equal(p, q)
    # Filling the reservoir opens no span: set-up is not traced.
    assert _names(tracing.calls()) == ["train.draw", "train.step"] * 2
    step = tracing.calls("train.step")[0]
    assert _names(step.children) == [
        "train.to_device", "train.optimizer", "train.forward",
        "train.backward", "train.clip", "train.optimizer"]
    assert step.counters == {}
    # The model's call lies under the forward phase.
    assert _names(step.children[2].children) == ["sbmc.forward"]
    assert step.below["sbmc.forward"].calls == 1


def test_host_batch_step_records_the_step_and_the_late_read():
    rng = np.random.RandomState(6)
    batch = {k: np.stack([it[k] for it in _items(rng, 2)])
             for k in ("features", "radiance", "global_features",
                       "target_image")}
    torch.manual_seed(1)
    iface = DenoiserInterface(Multisteps(**SMALL), device="cpu")

    def fn():
        m = iface.train_step(batch)
        return iface.check_finite(m)
    loss, _ = _profiled(fn)
    assert np.isfinite(loss)
    assert _names(tracing.calls()) == ["train.step", "train.check_finite"]
    step = tracing.calls("train.step")[0]
    assert step.below["train.to_device"].calls == 1
    assert step.counters == {}


def test_step_on_given_slots_is_the_drawn_step():
    """``step_on`` with the slots ``draw`` gives is ``train_step``, with
    the same spans; a refresh opens none."""
    items = _items(np.random.RandomState(7), 4)
    a_iface, a = _reservoir(items)
    b_iface, b = _reservoir(items)

    def steps():
        out = []
        for _ in range(2):
            out.append(float(a.train_step()["loss"]))
            out.append(float(b.step_on(*b.draw())["loss"]))
        b.refresh(items[0])
        a.refresh(items[0])
        return out
    losses, _ = _profiled(steps)
    assert losses[0::2] == losses[1::2]
    for p, q in zip(a_iface.model.parameters(), b_iface.model.parameters()):
        assert torch.equal(p, q)
    assert _names(tracing.calls()) == ["train.draw", "train.step"] * 4


def test_profile_takes_the_union_of_device_intervals():
    assert profile.busy_ms([]) == 0
    assert profile.busy_ms([(0, 1000), (500, 1500), (2000, 2500),
                            (2100, 2200)]) == pytest.approx(2.0)


def test_profile_span_rows_share_the_unit_calls_device_time():
    def fn():
        with tracing.span("unit"):
            with tracing.span("a"):
                torch.ones(64).sum()
            with tracing.span("b"):
                pass
    _profiled(fn)
    call, = tracing.calls("unit")
    rows = profile.span_rows(call)
    assert [r[:2] for r in rows] == [("unit", 1), ("a", 1), ("b", 1)]
    assert rows[0][3] == pytest.approx(100.0)
    assert rows[1][2] == call.below["a"].device_ms
    assert rows[1][3] + rows[2][3] <= 100.0
