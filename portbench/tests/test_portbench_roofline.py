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


def test_k7_bounds_by_hand():
    """The union of C half-dense witnesses' gated rows of v[1:] read once,
    and their gate bytes: at release 21,844 rows of 2^15 words."""
    c = cfg("release")
    assert (c["m"] - 1) * c["d"] * 4 == 2_863_136_768
    one = (2_863_136_768 // 2 + 21_844) / 3.35e12 * 1e3  # 1,431,590,228 B
    ten = (2_863_136_768 * 1023 // 1024 + 10 * 21_844) / 3.35e12 * 1e3  # 2,860,559,176 B
    assert roofline.rowsum_bound_ms(c) == pytest.approx(one, rel=1e-12)
    assert roofline.rowsum_bound_ms(c, 10) == pytest.approx(ten, rel=1e-12)
    assert one == pytest.approx(0.4273, abs=5e-5) and ten == pytest.approx(0.8539, abs=5e-5)


def _read_k7(device, clients, proofs):
    from portbench import harness
    from portbench.trace import Trace

    rec = harness.Record(cfg("release"), 1.0, 1.0, proofs, [0.1] * proofs, None,
                         Trace((0.0, 1.0), device, []), traffic={"clients": clients})
    return harness.load_module(harness.metric_file("k7_roofline_pct.prove")).read(rec)


def test_k7_roofline_reads_both_forms():
    """One reader for K7's one-witness form, a launch a proof, and its
    many-witness form, a launch a batch of C; nothing without the kernel's
    name in the trace."""
    one = "(anonymous namespace)::gated_rowsum_kernel(unsigned int const*, unsigned char const*)"
    many = "void (anonymous namespace)::gated_rowsums_kernel<true>(unsigned int const*)"
    k3 = ("void eval_mac_kernel<3>(unsigned int const*)", 0.0, 0.025)
    proofs = [k3] + [(one, 0.03 + k * 1e-3, 0.03 + k * 1e-3 + 0.5e-3) for k in range(10)]
    assert _read_k7(proofs, 1, 10) == pytest.approx(
        100 * (2_863_136_768 // 2 + 21_844) / 3.35e12 * 1e3 / 0.5)  # 85.47 %
    batches = [k3, (many, 0.03, 0.031), (many, 0.04, 0.041)]
    assert _read_k7(batches, 10, 20) == pytest.approx(
        100 * (2_863_136_768 * 1023 // 1024 + 218_440) / 3.35e12 * 1e3 / 10 / 0.1)  # 85.39 %
    assert _read_k7([k3], 1, 10) is None
    renamed = [k3, ("(anonymous namespace)::gated_rowsum_v2_kernel(unsigned int const*)", 0.03,
                    0.0305)]
    assert _read_k7(renamed, 1, 10) is None
