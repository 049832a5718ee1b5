"""The port's step profiler and trace reader against the JAX package's:
the phases a profiled ``fit`` records (data wait, step, eval) and the
scalars it pushes into the train summary, as the JAX ``fit`` does;
``save`` strips the profiler; a ``set_profile(trace_dir)`` fit and a
standalone ``trace`` window write a ``torch.profiler`` Chrome trace;
``device_op_times`` and ``op_breakdown`` on a trace built by hand from a
list of kernel, copy and step events equal the JAX reader's on an XPlane
built from the same list.

Tolerances: phase names, counts and kernel counts are exact; the
breakdown's milliseconds hold to rtol 1e-12 (the port divides the
trace's microseconds by 1e3, the JAX reader picoseconds by 1e9).
"""

import json
import os

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.common import xplane as jxplane
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from zoo_tpu_torch.common import xplane
from zoo_tpu_torch.common.profiling import (
    PhaseTimer,
    StepProfiler,
    trace,
    trace_files,
)
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet
from zoo_tpu_torch.pipeline.api.keras.layers import Dense

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _model(J=False):
    m = (JSeq if J else Sequential)(name="prof")
    D = JDense if J else Dense
    m.add(D(16, activation="relu", input_shape=(8,)))
    m.add(D(1))
    m.compile(optimizer="sgd", loss="mse")
    return m


def _data(n=64):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype(np.float32)
    return x, x[:, :1] * 2.0


def test_phase_timer_stats():
    t = PhaseTimer()
    for dt in (0.01, 0.03):
        t.record(dt)
    s = t.stats()
    assert s["count"] == 2
    assert abs(s["avg_ms"] - 20.0) < 1e-6 and abs(s["max_ms"] - 30.0) < 1e-6


@pytest.mark.parametrize("with_val", [False, True])
def test_fit_records_the_phases_jax_records(with_val):
    x, y = _data()
    got = {}
    for name in ("port", "jax"):
        m = _model(name == "jax")
        m.set_profile()
        kw = {"device": "cpu"} if name == "port" else {}
        m.fit(x, y, batch_size=16, nb_epoch=2, verbose=0,
              validation_data=(x[:16], y[:16]) if with_val else None, **kw)
        stats = m.get_profile_stats()
        tags = {t: len(m.get_train_summary(t)) if name == "port" else
                len(m.train_summary.read_scalar(t))
                for t in ("StepTimeMs", "DataTimeMs", "EvalTimeMs")}
        got[name] = ({k: v["count"] for k, v in stats.items()
                      if k != "reshard"}, tags)
        assert all(v["avg_ms"] >= 0 for v in stats.values())
        m.clear_profile()
        assert m.get_profile_stats() == {}
    assert got["port"] == got["jax"]
    assert got["port"][0]["step"] == 8
    assert ("eval" in got["port"][0]) == with_val


def test_save_strips_the_profiler_and_the_feed(tmp_path):
    m = _model()
    m.set_profile()
    x, y = _data()
    m.fit(x, y, batch_size=16, nb_epoch=1, verbose=0, device="cpu")
    assert m._staging_pool is not None and m.feed_stats is not None
    p = m.save(str(tmp_path / "m.zoo"))
    loaded = KerasNet.load(p, device="cpu")
    for attr in ("_profiler", "_staging_pool", "feed_stats"):
        assert getattr(loaded, attr, None) is None
    assert m._profiler is not None and m._staging_pool is not None
    np.testing.assert_array_equal(loaded.predict(x, device="cpu"),
                                  m.predict(x, device="cpu"))


def test_profiled_fit_and_trace_window_write_chrome_traces(tmp_path):
    m = _model()
    m.set_profile(trace_dir=str(tmp_path / "fit"), trace_epochs=1)
    x, y = _data(32)
    m.fit(x, y, batch_size=16, nb_epoch=2, verbose=0, device="cpu")
    files = trace_files(str(tmp_path / "fit"))
    assert len(files) == 1 and m._profiler.traces == files
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # no card here: no device event, an empty breakdown
    assert xplane.device_op_times(files[0], include_async=True) == {}
    with trace(str(tmp_path / "win")) as out:
        m.predict(x, batch_size=16, device="cpu")
    assert out and os.path.exists(out[0])
    assert trace_files(str(tmp_path / "win")) == out


def test_step_profiler_syncs_only_a_card():
    p = StepProfiler(device="cpu")
    p.synchronize()   # a no-op off CUDA
    with p.phase("step"):
        pass
    assert p.stats()["step"]["count"] == 1
    assert p.epoch_scalars().keys() == {"StepTimeMs"}


# -- one event list, as a Chrome trace and as an XPlane -------------------

# (name as CUPTI reports it, microseconds)
KERNELS = [("void zt::conv_tc_kernel<128, 3>(ConvParams)", 120),
           ("void zt::conv_tc_kernel<128, 3>(ConvParams)", 80),
           ("void sgd_kernel<float>(float*, float const*)", 10),
           ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN", 50),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 7)]
COPIES = [("Memcpy HtoD (Pinned -> Device)", 30),
          ("Memcpy HtoD (Pinned -> Device)", 20), ("Memset (Device)", 3)]
STEPS = [("ProfilerStep#0", 1000)]


def _chrome(path):
    ev = []
    t = 0
    for full, us in KERNELS:
        ev.append({"ph": "X", "cat": "kernel", "name": full, "pid": 0,
                   "tid": 7, "ts": t, "dur": us})
        t += us
    for full, us in COPIES:
        ev.append({"ph": "X", "cat": "gpu_memcpy" if "cpy" in full
                   else "gpu_memset", "name": full, "pid": 0, "tid": 9,
                   "ts": t, "dur": us})
    for full, us in STEPS:
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": full,
                   "pid": 0, "tid": 7, "ts": 0, "dur": us})
        ev.append({"ph": "X", "cat": "user_annotation", "name": full,
                   "pid": 1, "tid": 1, "ts": 0, "dur": us})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
               "tid": 1, "ts": 0, "dur": 40})
    ev.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
               "tid": 7, "ts": 0})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def _varint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(n, payload):
    return _varint((n << 3) | 2) + _varint(len(payload)) + payload


def _vfield(n, v):
    return _varint(n << 3) + _varint(v)


def _xplane(path):
    """One GPU plane: kernels on ``XLA Ops``, copies on ``Async XLA Ops``,
    the step on ``Steps``; each event's duration inline (picoseconds),
    each kernel named by its bare name (the name an XLA GPU plane
    gives)."""
    names, meta = {}, b""
    for full, _ in KERNELS + COPIES + STEPS:
        bare = xplane.kernel_name(full)
        if bare not in names:
            names[bare] = len(names) + 1
            meta += _field(4, _vfield(1, names[bare]) + _field(
                2, _vfield(1, names[bare]) + _field(2, bare.encode())))

    def line(title, events):
        body = b"".join(_field(4, _vfield(1, names[xplane.kernel_name(f)])
                               + _vfield(3, us * 1_000_000))
                        for f, us in events)
        return _field(3, _field(2, title) + body)

    plane = _field(2, b"/device:GPU:0") + meta + line(b"XLA Ops", KERNELS) \
        + line(b"Async XLA Ops", COPIES) + line(b"Steps", STEPS)
    with open(path, "wb") as f:
        f.write(_field(1, plane))


@pytest.mark.parametrize("include_async", [False, True])
def test_trace_reader_gives_jaxs_breakdown(tmp_path, include_async):
    cpath, xpath = str(tmp_path / "t.pt.trace.json"), str(tmp_path / "t.pb")
    _chrome(cpath)
    _xplane(xpath)
    mine = xplane.device_op_times(cpath, include_async=include_async)
    theirs = jxplane.device_op_times(xpath, include_async=include_async)
    assert {xplane.kernel_name(k): v[1] for k, v in mine.items()} == \
        {k: v[1] for k, v in theirs.items()}
    for k, (ms, _) in mine.items():
        np.testing.assert_allclose(ms, theirs[xplane.kernel_name(k)][0],
                                   rtol=1e-12)
    rows = xplane.op_breakdown(cpath, include_async=include_async)
    jrows = jxplane.op_breakdown(xpath, include_async=include_async)
    assert [(k, n) for k, _, n in rows] == [(k, n) for k, _, n in jrows]
    np.testing.assert_allclose([ms for _, ms, _ in rows],
                               [ms for _, ms, _ in jrows], rtol=1e-12)
    assert dict((k, n) for k, _, n in rows)["conv_tc_kernel"] == 2
    assert ("Memcpy" in dict((k, n) for k, _, n in rows)) == include_async


def test_kernel_name_strips_the_cxx_decoration():
    assert [xplane.kernel_name(f) for f, _ in KERNELS] == [
        "conv_tc_kernel", "conv_tc_kernel", "sgd_kernel",
        "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN",
        "vectorized_elementwise_kernel"]
    assert xplane.kernel_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
