"""The roofline counts at the configurations' shapes, from the shapes alone."""

import json

import pytest

from conftest import ROOT
from portbench import roofline


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_release_bounds():
    c = cfg("release")
    assert roofline.terms(c) == 87_381
    assert roofline.stream_blocks(c) == -(-87_381 * 1470 * 92 // 16)
    assert roofline.eval_bound_ms(c) == pytest.approx(19.93, abs=0.005)
    assert roofline.encrypt_bound_ms(c) == pytest.approx(19.93, abs=0.005)


def test_bounds_scale_with_the_terms():
    """The same LWE parameters at d = 2^16, m = 43,690: twice the terms, twice
    the bound, from the shapes alone."""
    c = dict(cfg("release"), d=1 << 16, m=43_690)
    assert roofline.terms(c) == 174_762
    assert roofline.eval_bound_ms(c) == pytest.approx(39.9, abs=0.05)
    assert roofline.encrypt_bound_ms(c) == pytest.approx(39.9, abs=0.05)


def test_bound_is_the_larger_of_the_three():
    assert roofline.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert roofline.bound_ms(0, roofline.PEAK_INT32 * 2) == pytest.approx(2e3)
    assert roofline.bound_ms(1, 1, roofline.PEAK_INT8 * 3) == pytest.approx(3e3)
    assert roofline.OPS_PER_BLOCK == 452


def test_readers_read_nothing_without_their_kernel():
    """K3's roofline and the glue beside it read nothing when K3's name is not
    in the trace: the glue would otherwise hold K3's time."""
    from portbench import harness
    from portbench.trace import Trace

    def read(name, device):
        trace = Trace((0.0, 1.0), device, [])
        rec = harness.Record(cfg("release"), 1.0, 1.0, 10, [0.1] * 10, None, trace)
        return harness.load_module(harness.metric_file(name)).read(rec)

    k3 = "void eval_mac_kernel<3>(unsigned int const*)"
    with_k3 = [(k3, 0.0, 0.25), ("ntt_pass_kernel", 0.3, 0.31)]
    assert read("glue_device_ms.prove", with_k3) == pytest.approx(1.0)
    assert read("k3_roofline_pct.prove", with_k3) == pytest.approx(
        100 * roofline.eval_bound_ms(cfg("release")) / 25.0)
    assert read("device_idle_pct.prove", with_k3) == pytest.approx(74.0)
    renamed = [("eval_mac_v2_kernel", 0.0, 0.25), ("ntt_pass_kernel", 0.3, 0.31)]
    assert read("glue_device_ms.prove", renamed) is None
    assert read("k3_roofline_pct.prove", renamed) is None
