"""The reduction of a profiled slice, on made-up events."""
import pytest

from perfbench import trace


class Kind:
    def __init__(self, name):
        self.name = name


class Event:
    def __init__(self, name, start, end, device="CUDA", annotation=False):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return Kind(self._dev)

    def is_user_annotation(self):
        return self._ann


def test_reduce_unions_the_device_and_names_its_gaps():
    ms = 1_000_000
    events = [
        Event("cudaGraphLaunch", 0, 3 * ms, "CPU"),
        Event("gemm", 1 * ms, 4 * ms),
        Event("add", 2 * ms, 5 * ms),           # overlaps the gemm
        Event("cudaMemcpyAsync", 6 * ms, 9 * ms, "CPU"),
        Event("argmax", 8 * ms, 9 * ms),
        Event("span", 0, 20 * ms, "CUDA", annotation=True),   # left out
        Event("cudaGraphLaunch", 12 * ms, 13 * ms, "CPU"),
        Event("gemm", 13 * ms, 14 * ms),
    ]
    out = trace.reduce(events, 0.05)
    assert out["window_s"] == 0.05
    assert out["busy_s"] == pytest.approx(6e-3)
    assert out["device_s"] == pytest.approx(
        {"gemm": 4e-3, "add": 3e-3, "argmax": 1e-3})
    gaps = dict(out["idle_gaps"])
    # 0-1 ms inside the launch; 5-8 ms: the copy's call is open at 6.5;
    # 9-13 ms: nothing open at 11
    assert gaps == pytest.approx({"cudaGraphLaunch": 1e-3,
                                  "cudaMemcpyAsync": 3e-3,
                                  trace.OUTSIDE: 4e-3})
    assert out["device_ops"][0] == ["gemm", pytest.approx(4e-3)]
