"""The reduction of a profiled stretch, on synthetic profiler events (no card needed).

Events carry what torch's raw kineto events give on the card (name, device,
start, length, user annotation), from which ``trace`` works out each one's kind.
"""

import pytest

from perfbench import costs, trace


class Event:
    def __init__(self, name, start_us, dur_us, device="cpu", annotation=False):
        self._name, self._start, self._dur = name, int(start_us * 1000), int(dur_us * 1000)
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device == "cuda" else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._annotation


def _stretch(drop_flash=False):
    events = [
        Event(trace.Profiled.WINDOW, 0, 1000, annotation=True),
        Event("pb.prefill", 0, 600, annotation=True),
        Event("pb.prefill", 0, 600, device="cuda"),  # the annotation's shadow on the device
        Event("aten::mm", 10, 50),
        Event("cudaLaunchKernel", 700, 250),
        Event("nvjet_tst_320x128", 100, 200, device="cuda"),
        Event("void (anonymous namespace)::flash_fwd_bf16<96>(float const*)", 250, 150, device="cuda"),
        Event("void (anonymous namespace)::ssd_chunk_state<128, 64, 4>(x)", 500, 20, device="cuda"),
        Event("void (anonymous namespace)::ssd_state_pass(x)", 520, 20, device="cuda"),
        Event("void (anonymous namespace)::ssd_chunk_scan<128, 64, 4>(x)", 540, 20, device="cuda"),
        Event("Memcpy DtoD (Device -> Device)", 560, 40, device="cuda"),
        Event("late kernel", 990, 100, device="cuda"),  # runs past the stretch: clipped to it
    ]
    if drop_flash:
        events = [e for e in events if "flash" not in e.name()]
    launches = {"flash_attention": 1, "ssd_scan": 1, "ssd_scan_bwd": 0}
    calls = [("flash_attention", (1, 64, 64, 4, 4, 96, 2, True, 0)), ("ssd_scan", (1, 256, 4, 64, 64, 2, 128, False))]
    return trace.reduce_profile(events, launches, calls)


def test_busy_time_is_the_union_of_device_intervals_inside_the_stretch():
    r = _stretch()
    assert r["window_s"] == pytest.approx(1e-3)
    # [100, 400] + [500, 600] + [990, 1000] microseconds
    assert r["busy_s"] == pytest.approx(410e-6)
    assert r["kernels"] == 6 and r["complete"] == {"flash_attention": True, "ssd_scan": True, "ssd_scan_bwd": True}
    assert trace.idle_percent(r) == pytest.approx(59.0)
    assert r["idle_gaps"][0] == ("between spans: cudaLaunchKernel", pytest.approx(390e-6))
    assert [name for name, _ in r["idle_gaps"][1:]] == ["prefill: no host op", "prefill: aten::mm"]


def test_a_kernel_roofline_is_least_time_over_device_time():
    r = _stretch()
    least = costs.call_least_ms("flash_attention", (1, 64, 64, 4, 4, 96, 2, True, 0))
    assert trace.kernel_roofline(r, "flash_attention") == pytest.approx(100 * least / 1e3 / 150e-6)
    assert trace.kernel_roofline(r, "ssd_scan_bwd") is None  # no call in the stretch


def test_a_stretch_that_lost_records_gives_no_kernel_figure():
    r = _stretch(drop_flash=True)
    assert r["complete"]["flash_attention"] is False
    assert trace.kernel_roofline(r, "flash_attention") is None
    assert trace.idle_percent(r) is None


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::tc_chunk_dx<128, 64, 4>(float const*, int)", "tc_chunk_dx"),
    ("void (anonymous namespace)::bwd_head_sum<__nv_bfloat16>(x)", "bwd_head_sum"),
    ("void at::native::elementwise_kernel<128, 4>(int)", "elementwise_kernel"),
    ("nvjet_tst_320x128_64x3_2x1_v_bz_coopB_NNT", "nvjet_tst_320x128_64x3_2x1_v_bz_coopB_NNT"),
])
def test_kernel_base_names(name, base):
    assert trace.base_name(name) == base
