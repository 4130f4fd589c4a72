"""The frozen yardstick against counts worked by hand at the kernel table's
shapes (PERF.md, the kernel table: nq 64, k 16, d 384, 1,048,576 rows,
IVF1024 x 4096 at nprobe 16)."""
import numpy as np
import pytest

from ragbench.roofline import (H100, bound, ivf_topk_cost, percentile,
                               sq8_topk_cost, topk_search_cost)


def test_peaks_are_the_data_sheets():
    assert (H100.peak_flops, H100.hbm_bw, H100.fp32_flops,
            H100.int8_ops) == (989e12, 3.35e12, 67e12, 1979e12)


def test_ivf_topk_at_the_tables_shape():
    # 635,904 live rows in the distinct probed buckets (about 621 of the
    # 1,024 a batch of 64 probes 16 each): rows 635,904 * 384 * 4 =
    # 976,748,544; centroids 1,024 * 384 * 4 = 1,572,864; queries 98,304;
    # lists 64 * 16 * 8 = 8,192: 978,427,904 bytes
    c = ivf_topk_cost(64, 384, 16, 1024, 635_904, 1_017_446)
    assert c["bytes"] == 978_427_904
    t, by = bound(c["bytes"], c["flops"], c["peak"])
    assert by == "bytes" and t * 1e3 == pytest.approx(0.2921, abs=5e-5)
    assert c["flops"] == 2 * 64 * 1024 * 384 + 2 * 1_017_446 * 384


def test_flat_and_sq8_scans():
    n = 1 << 20
    f = topk_search_cost(64, 384, 16, n)
    assert f["bytes"] == n * 384 * 4 + 64 * 384 * 4 + 64 * 16 * 8
    t, by = bound(f["bytes"], f["flops"], f["peak"])
    assert by == "operations" and t * 1e3 == pytest.approx(0.76925, abs=1e-5)
    s = sq8_topk_cost(64, 384, 16, n)
    assert s["bytes"] == n * 384 + 384 * 4 + 64 * 384 * 4 + 64 * 16 * 8
    t, by = bound(s["bytes"], s["flops"], s["peak"])
    assert by == "bytes" and t * 1e3 == pytest.approx(0.1202, abs=5e-5)


def test_percentile_is_numpys_linear_rule():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 451):
        xs = rng.standard_normal(n)
        for q in (50.0, 95.0, 99.0):
            assert percentile(list(xs), q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12, abs=1e-12)
    assert percentile([], 95.0) == 0.0
