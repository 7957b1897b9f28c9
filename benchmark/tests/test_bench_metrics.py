"""The metric arithmetic on made-up records: the rate over the window, the
95th percentile over every call, the union of device intervals and the
idle gaps named by span, rooflines and mfu from given counts."""

import statistics
import types

import pytest

import run
from harness.spec import HERE, load_json, load_module
from harness.trace import Interval, Trace

HP = {"outputs_per_step": 1}
PEAKS = load_json(HERE / "peaks.json")


def _metric(name):
    return load_module(HERE / "metrics" / f"{name}.py", "metric")


def _count(symbols, nbytes, flops):
    return types.SimpleNamespace(SYMBOLS=symbols, OPERANDS="f32",
                                 count=lambda hp, call: (nbytes, flops))


def _trace():
    # two calls' spans over 0..100 us; device busy 10-30, 20-40 (overlap),
    # 60-70 and a copy 80-85
    spans = [Interval("make_request", 0, 5_000),
             Interval("predict_step", 5_000, 75_000),
             Interval("readback", 75_000, 100_000)]
    device = [Interval("void fused_decode_kernel<true, float>(DecArgs)",
                       10_000, 30_000),
              Interval("elementwise_kernel", 20_000, 40_000),
              Interval("void encoder_trunk_kernel<true>(EncArgs)", 60_000,
                       70_000),
              Interval("Memcpy DtoH (Device -> Pageable)", 80_000, 85_000,
                       kernel=False)]
    return Trace(device=device, spans=spans)


def _run(calls, window_s, trace=None, counts=None):
    return run.Run(HP, calls, window_s, 12.5, trace, counts or {}, PEAKS)


def test_rate_over_the_window_and_p95_over_all_calls():
    calls = [dict(T=10, steps=450, rows=1, ms=float(m))
             for m in range(1, 101)]
    r = _run(calls, 2.0)
    assert _metric("frames_per_s").read(r) == pytest.approx(450 * 100 / 2.0)
    p95 = _metric("utt_ms_p95").read(r)
    assert p95 == pytest.approx(95.05)
    assert p95 == statistics.quantiles(range(1, 101), n=20,
                                       method="inclusive")[18]
    assert _metric("setup_s").read(r) == 12.5


def test_union_of_device_intervals_and_idle_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy() == [(10_000, 40_000), (60_000, 70_000), (80_000, 85_000)]
    assert t.busy_s == pytest.approx(45e-6)
    gaps = t.gaps()
    assert gaps == [("make_request", pytest.approx(10e-6)),
                    ("predict_step", pytest.approx(20e-6)),
                    ("predict_step", pytest.approx(10e-6)),
                    ("readback", pytest.approx(15e-6))]
    r = _run([dict(T=1, steps=1, rows=1, ms=1.0)] * 2, 1e-4, t)
    assert _metric("idle_pct").read(r) == pytest.approx(55.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void fused_decode_kernel<true, float>"
                                  "(DecArgs)",
                                  pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["predict_step", pytest.approx(20e-6)]


def test_rooflines_mfu_and_plain_kernels_from_given_counts():
    counts = {"fused_decode": _count(("fused_decode_kernel",), 335, 495),
              "fused_encode": _count(("encoder_trunk_kernel",), 3.35e6, 0),
              "attention_keys": _count((), 0, 990)}
    calls = [dict(T=1, steps=1, rows=1, ms=1.0)] * 2
    r = _run(calls, 1e-4, _trace(), counts)
    # decode: 2 calls x max(335 B / 3.35e12, 495 F / 495e12) = 2e-10 s
    # (bytes-bound) of the 20 us of its kernel
    assert _metric("fused_decode_roofline").read(r) == pytest.approx(1e-3)
    # encode: 2 x 1e-6 s of its 10 us
    assert _metric("fused_encode_roofline").read(r) == pytest.approx(20.0)
    # all FLOPs: 2 x (495 + 990) over 100 us at 495 TFLOP/s
    assert _metric("mfu_pct").read(r) == pytest.approx(
        100 * 2 * 1485 / (1e-4 * 495e12))
    # the one kernel no count lists: 20 us over 2 calls
    assert _metric("plain_ms_per_call").read(r) == pytest.approx(0.01)
    assert _metric("kernels_per_call").read(r) == 1.5


def test_kernel_names_match_symbols_whole():
    from harness.trace import is_symbol
    assert is_symbol("void fused_decode_kernel<true, float>(DecArgs)",
                     ["fused_decode_kernel"])
    assert is_symbol("encoder_rnn_kernel", ["encoder_rnn_kernel"])
    assert not is_symbol("void fused_decode_kernel_v2<1>(A)",
                         ["fused_decode_kernel"])
    assert not is_symbol("void at::native::reduce_kernel<512>(R)",
                         ["fused_decode_kernel", "encoder_rnn_kernel"])


def test_readers_give_nothing_without_a_trace():
    r = _run([dict(T=1, steps=1, rows=1, ms=1.0)], 1.0)
    for name in ("idle_pct", "mfu_pct", "fused_decode_roofline",
                 "fused_encode_roofline", "plain_ms_per_call",
                 "kernels_per_call"):
        assert _metric(name).read(r) is None
