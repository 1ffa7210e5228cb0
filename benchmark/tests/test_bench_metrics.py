"""The roofline's count on a hand-worked digit set, the union of device
intervals, the idle gaps' attribution, and the readers."""
import os
from types import SimpleNamespace

import pytest

from harness import spec, trace
from metrics import roofline


def test_msm_work_by_hand():
    # k = 1 vector over n = 2 points with 3 non-zero signed digits:
    # 3 mixed adds (7 muls), 32 windows x 256 full adds (9), then
    # 31 windows x (8 doublings (8) + 1 add (9))
    muls = 3 * 7 + 32 * 256 * 9 + 31 * (8 * 8 + 9)
    assert muls == 76012
    assert roofline.msm_work(1, 2, 3) == (muls * 64, 2 * 64 + 32 * 2)
    # k = 2 over 5 points, 40 digits
    muls2 = 40 * 7 + 64 * 256 * 9 + 2 * 31 * 73
    assert roofline.msm_work(2, 5, 40) == (muls2 * 64, 5 * 64 + 64 * 5)


def test_least_seconds():
    sec, by = roofline.least_seconds(64 * 132 * 2e9, 1.0, 2e9)
    assert by == "compute" and sec == pytest.approx(1.0)
    sec, by = roofline.least_seconds(1, 3.35e12, 2e9)
    assert by == "bytes" and sec == pytest.approx(1.0)


def _ctx(**kw):
    base = dict(spans={}, requests=2, work=8, latencies=[], busy_s=1.0,
                window_s=4.0, kernels={}, msm_digits=[],
                gpu={"clocks.max.sm": 1980.0})
    base.update(kw)
    return SimpleNamespace(**base)


def test_share():
    products, nbytes = roofline.msm_work(3, 1000, 50000)
    least, _ = roofline.least_seconds(products, nbytes, 1980e6)
    ctx = _ctx(msm_digits=[(3, 1000, 50000)],
               kernels={"(anonymous namespace)::bucket_accumulate_kernel":
                        least * 2, "horner_kernel(int)": least * 2,
                        "at::native::elementwise": 5.0})
    assert roofline.share(ctx) == pytest.approx(25.0)
    assert roofline.share(_ctx()) is None
    assert roofline.share(_ctx(msm_digits=[(1, 1, 1)], gpu={})) is None


def test_device_activity_union():
    events = [("a", 0, 10), ("b", 5, 15), ("a", 20, 30), ("c", 22, 25),
              ("d", 40, 41)]
    busy, merged, by_name = trace.device_activity(events)
    assert busy == pytest.approx(26e-9)
    assert merged == [[0, 15], [20, 30], [40, 41]]
    assert by_name["a"] == pytest.approx(20e-9)


def test_idle_gaps_by_span():
    merged = [[10, 20], [50, 60]]
    spans = {"prepare": [(0, 40)], "ipa": [(30, 45)]}
    gaps = trace.idle_gaps(merged, 0, 100, spans)
    # 0-10 prepare, 20-50 (middle 35: ipa inside prepare), 60-100 none
    assert gaps == pytest.approx({"host: prepare": 10e-9,
                                  "host: ipa": 30e-9,
                                  "host: outside the spans": 40e-9})


def _reader(name):
    return spec.load_module(os.path.join(spec.BENCH, "metrics",
                                         name + ".py"), "r_" + name).read


def test_readers():
    ctx = _ctx(spans={"prepare": [(0, 2_000_000_000)],
                      "ipa": [(0, 1_000_000_000), (0, 3_000_000_000)],
                      "image_hash": [(0, 4_000_000_000)]},
               latencies=[float(i) for i in range(1, 101)])
    assert _reader("prepare_s_per_proof")(ctx) == pytest.approx(0.25)
    assert _reader("ipa_s_per_proof")(ctx) == pytest.approx(0.5)
    assert _reader("image_hash_s_per_request")(ctx) == pytest.approx(2.0)
    assert _reader("verify_p95_s")(ctx) == 95.0
    for side in ("prove", "verify"):
        assert _reader(f"device_idle_share.{side}")(ctx) == \
            pytest.approx(75.0)
        assert _reader(f"msm_roofline.{side}")(ctx) is None
    assert _reader("prepare_s_per_proof")(_ctx()) is None
    assert _reader("device_idle_share.prove")(_ctx(busy_s=0.0)) is None


def test_msm_digits_outside_the_yardstick_fail():
    import torch
    rec = trace.Recorder()
    rec.active = True
    wrapped = rec._msm(lambda digits_t: None)
    wrapped(torch.tensor([[1, -128, 0]] * 64, dtype=torch.int8))
    assert rec.msm_digits() == [(2, 3, 128)]
    with pytest.raises(RuntimeError, match="windows a vector"):
        wrapped(torch.zeros(48, 3, dtype=torch.int8))
    wrapped(torch.full((32, 2), 200, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="signed digits"):
        rec.msm_digits()
