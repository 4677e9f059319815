"""The comparison: exact values, the ORDER BY keys in order, any order
within a tie, and any rows of the last tied group under a LIMIT."""

from portbench.check import compare


def test_exact_and_unordered():
    want = {"a": [1, 2], "b": ["x", "y"]}
    assert compare({"b": ["y", "x"], "a": [2, 1]}, want, [], None) is None
    assert compare({"a": [1, 3], "b": ["x", "y"]}, want, [], None)
    assert compare({"a": [1], "b": ["x"]}, want, [], None)
    assert compare({"a": [1, 2]}, want, [], None)


def test_order_and_ties():
    want = {"k": [3, 2, 2, 1], "v": [10, 20, 21, 30]}
    assert compare({"k": [3, 2, 2, 1], "v": [10, 21, 20, 30]}, want, ["k"], None) is None
    assert compare({"k": [2, 3, 2, 1], "v": [20, 10, 21, 30]}, want, ["k"], None)


def test_limit_boundary_ties():
    # limit 2: the reference holds every row tied with the second
    want = {"k": [9, 5, 5, 5], "v": [1, 2, 3, 4]}
    assert compare({"k": [9, 5], "v": [1, 4]}, want, ["k"], 2) is None
    assert compare({"k": [9, 5], "v": [1, 7]}, want, ["k"], 2)
    assert compare({"k": [9, 5, 5], "v": [1, 2, 3]}, want, ["k"], 2)


def test_none_and_big_ints():
    assert compare({"s": [None]}, {"s": [None]}, [], None) is None
    assert compare({"s": [10 ** 30 + 1]}, {"s": [10 ** 30]}, [], None)


def test_device_time_inside_intervals():
    """Kernel time is read by launch: a kernel counts for the interval in
    which its launch lies, whenever it ran."""
    from torch.autograd import DeviceType

    from portbench import trace
    from portbench.tests.test_trace import Event, launched, reduced

    ev = [Event(trace.SLICE_RANGE, 0, 100, DeviceType.CPU), *launched("a", 1, 0, 10, 1),
          *launched("b", 15, 20, 30, 2), *launched("c", 19, 40, 50, 3)]
    r = reduced(ev)
    assert round(trace.kernel_s(r, 0, 50) * 1e9) == 30
    assert round(trace.kernel_s(r, 5, 18) * 1e9) == 10
    assert trace.kernel_s(r, 20, 50) == 0
    assert round(trace.kernel_s(r, 19, 99) * 1e9) == 10
