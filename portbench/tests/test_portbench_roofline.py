"""The kernels' yardstick against hand counts (the smoke run's bounds at
the 180 s batch's shapes, PERF.md's table of kernels), and the trace's
arithmetic on a synthetic trace."""

from pathlib import Path

import pytest
import torch

from portbench import manifest, roofline
from portbench import trace as tracing

N = 1 << 23          # the staged plan of the 180 s bucket
N180 = 7_938_000     # 180 s at 44.1 kHz
CSRC = Path(__file__).resolve().parents[2] / "amw_tpu_torch" / "csrc"


def meta(*shape):
    return torch.empty(shape, device="meta")


def bound_ms(entry, *args):
    b, f = roofline.WORK[entry](*args)
    return roofline.bound_s(b, f) * 1e3


def test_box_and_envelopes():
    x = meta(16, N180)
    assert bound_ms("amw_box_smooth", x, x, 16, N180, 67) == pytest.approx(
        0.3033, abs=1e-4)
    # 2 x 16 x 7 938 000 float32 read and written once
    b, f = roofline.WORK["amw_env_scan"](x, x, 16, N180, 1, 2, 3, 0.1, 0.2)
    assert (b, f) == (2 * 16 * N180 * 4, 16 * N180 * 5)


def test_staged_fft_kernels():
    t1 = meta(N)
    planes = meta(8, N)
    # kernel 4: two packed planes of 8 rows in, two of 2^23 out, T1 once
    assert bound_ms("amw_fft_stage_a", meta(8, N180), meta(8, N180), t1, t1,
                    planes, planes, 8, N180, N180, N // 128, 0, 0, 0,
                    1.0) == pytest.approx(0.3319, abs=1e-4)
    # kernel 5 at K = 2
    assert bound_ms("amw_fft_inv_join", meta(16, N), meta(16, N), t1, t1,
                    meta(2, 16, N), 16, 8, N // 128, 1.0) == pytest.approx(
        0.6611, abs=1e-4)
    t2 = meta(2 * N // 128)
    for K, want in ((2, 0.5208), (4, 0.8814)):     # kernel 9
        assert bound_ms("amw_fft_bccb", planes, planes, meta(K, 2, N), t2,
                        t2, t2, t2, planes, planes, meta(K * 8, N),
                        meta(K * 8, N), 8, 512, K) == pytest.approx(
            want, abs=1e-4)
    assert bound_ms("amw_fft_bc_cb", planes, planes, meta(2, N), t2, t2, t2,
                    t2, planes, planes, planes, planes, 8,
                    512) == pytest.approx(0.3406, abs=1e-4)   # kernel 8
    assert bound_ms("amw_fft_reduce_packed", meta(32, N), meta(32, N), t1,
                    t1, meta(4, 8), meta(16, N), 8, 4, N // 128,
                    1.0) == pytest.approx(0.8213, abs=1e-4)   # kernel 11


def test_every_entry_point_of_the_port_has_a_yardstick():
    from amw_tpu_torch.ops import _cuda

    assert set(_cuda._ENTRIES) - set(roofline.WORK) == {"amw_env_step_clock"}


def test_kernel_names_of_the_sources():
    names = roofline.kernel_names(CSRC)
    assert {"box_walk_kernel", "col_dft128_kernel", "cstage_multi_kernel",
            "bc_onepass_kernel", "breg_inv_kernel", "env_staged_kernel",
            "reduce_kernel"} <= names


@pytest.mark.parametrize("name, kind", [
    ("void amw_fft::col_dft128_kernel<true, false, 2>(float const*)", "port"),
    ("void (anonymous namespace)::box_walk_kernel<67, 32>(float)", "port"),
    ("amw_fft::breg_inv_kernel(float const*, float*)", "port"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>()",
     "torch"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", "torch"),
    ("void regular_fft<256u, EPT<8u>, 32u>(float2*)", "cufft"),
    ("dpRadix0032B::kernel1Mem<unsigned int, double>(float)", "cufft"),
])
def test_kernel_kinds(name, kind):
    assert tracing.kind_of(name, roofline.kernel_names(CSRC)) == kind


def synthetic():
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
           "ts": 1000.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "ts": 1100.0, "dur": 200.0,
           "name": "void amw_fft::col_dft128_kernel<false, true, 2>(float)"},
          {"ph": "X", "cat": "kernel", "ts": 1200.0, "dur": 200.0,
           "name": "void at::native::reduce_kernel<512, 1>(float)"},
          {"ph": "X", "cat": "kernel", "ts": 1500.0, "dur": 100.0,
           "name": "void regular_fft<256u>(float2*)"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 1700.0, "dur": 50.0,
           "name": "Memcpy DtoH (Device -> Pageable)"},
          {"ph": "X", "cat": "kernel", "ts": 2500.0, "dur": 50.0,
           "name": "void at::native::outside_the_window(float)"},
          {"ph": "X", "cat": "cuda_runtime", "ts": 1410.0, "dur": 80.0,
           "name": "cudaLaunchKernel"}]
    tr = tracing.parse(ev, 2, roofline.kernel_names(CSRC))
    tr.bound_s = 50e-6
    tr.launches = [("amw_fft_stage_a", 1, 1)] * 4
    return tr


def read(name, tr):
    return manifest.load_module(manifest.ROOT, "metrics", name).read(tr)


def test_trace_arithmetic():
    tr = synthetic()
    assert tr.window_s == pytest.approx(1e-3)
    # union: [1100, 1400] + [1500, 1600] + [1700, 1750] = 450 us
    assert tr.busy_s() == pytest.approx(450e-6)
    assert read("device.idle_share", tr) == pytest.approx(55.0)
    assert read("stages.torch_ms_per_batch", tr) == pytest.approx(0.1)
    assert read("graph.launches_per_batch", tr) == 1.5
    # 50 us of bound over the port's 200 us
    assert read("kernels_roofline", tr) == pytest.approx(25.0)
    gaps = tr.idle_gaps()
    assert gaps[0] == pytest.approx((0.75e-3, 0.25e-3))
    assert tr.host_at(0.42e-3) == "cudaLaunchKernel"
    bd = tracing.breakdown(tr)
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    assert len(bd["idle_gaps"]) == 4


def test_a_reader_with_nothing_to_read_returns_nothing():
    tr = tracing.Trace(steps=2, window_s=1.0)
    for m in manifest.load_benchmark()["per_layer"]:
        assert read(m["name"], tr) is None
