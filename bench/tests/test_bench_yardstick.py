"""The frozen arithmetic against hand-computed values at the kernel
table's shapes (PERF.md), and the per-layer readers on known inputs."""

import pytest

from bench import harness, yardstick as ys
from bench.tests import tiny_root

PUBMED = harness.load_cell(tiny_root.ROOT, "pubmed.train")
SFU = 132 * 16 * 1.98e9


def table_cfg() -> dict:
    """PubMed's widths at the kernel table's shapes (1M rows, K 4096)."""
    return dict(harness.nomad_config(PUBMED.config, 1).__dict__, n_points=1_000_000, n_clusters=4096)


def test_peaks():
    assert ys.PEAK_SFU_OPS == pytest.approx(4.18176e12)
    assert ys.Work(tensor_flops=495e12 / 3).bound_s() == pytest.approx(1.0)
    assert ys.Work(fp32_flops=67e12, nbytes=3.35e12 / 2).bound_s() == pytest.approx(1.0)


def test_k1_at_the_fit_step():
    B, k, S, K, d = 8192, 15, 16, 4096, 2
    fwd = ys.k1_fwd(B, k, S, K, d)
    assert fwd.sfu_ops == 8192 * 4096 + 8192 * 16 + 3 * 8192 * 15 == 34_054_144
    assert fwd.bound_s() == pytest.approx(34_054_144 / SFU) and fwd.bound_by() == "sfu"
    assert fwd.bound_s() * 1e3 == pytest.approx(0.00814, abs=5e-6)  # PERF.md: 0.00814 ms
    bwd = ys.k1_bwd(B, k, S, K, d)
    assert bwd.nbytes == 4 * 1_335_296 and bwd.bound_by() == "bytes"
    assert bwd.bound_s() * 1e3 == pytest.approx(0.00159, abs=5e-6)  # PERF.md: 0.00159 ms


def test_k2_k3_at_the_build():
    k2 = ys.k2(16384, 4096, 768)
    assert k2.tensor_flops == 2 * 16384 * 4096 * 768 + 2 * 16384 * 4096
    assert k2.bound_s() * 1e3 == pytest.approx(0.626, abs=5e-4)  # PERF.md: 0.626 ms
    cells = ys.k3(256, 305, 305, 768)
    assert cells.tensor_flops == 256 * (2 * 305 * 305 * 768 + 4 * 305 * 305)
    assert cells.bound_s() * 1e3 == pytest.approx(0.222, abs=5e-4)  # PERF.md: 0.222 ms
    rows = ys.k3(256, 1, 305, 768, tensor=False)
    assert rows.bound_by() == "bytes"


def test_k4_k5_at_the_serving_batch():
    assert ys.k4_fwd(1024, 4096, 2).bound_s() * 1e3 == pytest.approx(0.00100, abs=5e-6)
    assert ys.k4_bwd(1024, 4096, 2).bound_s() * 1e3 == pytest.approx(0.00100, abs=5e-6)
    k5 = ys.k5_fwd(1024, 15, 2)
    assert k5.nbytes == 4.0 * (2048 + 30720 + 15360 + 1024) + 4096
    assert k5.bound_s() * 1e3 == pytest.approx(0.00006, abs=5e-6)


def test_train_mfu_reads_the_epoch_against_its_bound():
    assert ys.steps_per_epoch(harness.nomad_config(PUBMED.config, 1).__dict__) == 367  # the cell's 3M rows
    cfg = table_cfg()
    step = ys.train_step_work(cfg)
    assert step.bound_by() == "sfu"
    hand = 123 * (34_054_144 + 8192 * 16 + 3 * 8192 * 15) / SFU
    assert ys.epoch_work(cfg).bound_s() == pytest.approx(hand)
    read = harness.load_reader(tiny_root.ROOT / "bench", "train_mfu")
    ctx = {"cfg": cfg, "traffic": {"kind": "epochs"}, "window": {"units": 10, "seconds_per_unit": 0.4}}
    assert read(ctx) == pytest.approx(100 * hand / 0.4)


def test_roofline_readers_sum_launch_bounds_over_device_time():
    cfg = table_cfg()
    shape = (8192, 15, 16, 4096, 2)
    trace = {"units": 2, "kernels": {"void nomad_fwd_kernel<2, true>(float const*)": [246, 246 * 22e-6],
                                     "void nomad_bwd_kernel<2>(float const*)": [246, 246 * 3.2e-6]}}
    read = harness.load_reader(tiny_root.ROOT / "bench", "k1_roofline")
    want = 100 * (ys.k1_fwd(*shape).bound_s() + ys.k1_bwd(*shape).bound_s()) / (22e-6 + 3.2e-6)
    assert read({"cfg": cfg, "trace": trace}) == pytest.approx(want)
    assert read({"cfg": cfg, "trace": {"units": 2, "kernels": {}}}) is None  # a kernel off the path: silent
    k45 = harness.load_reader(tiny_root.ROOT / "bench", "k45_roofline")
    kern = {"void cauchy_kernel<2, false>(x)": [24, 24 * 4.4e-6], "void cauchy_kernel<2, true>(x)": [24, 24 * 5.1e-6],
            "attract_fwd_kernel(x)": [24, 24 * 1.5e-6], "attract_bwd_kernel(x)": [24, 24 * 1.7e-6]}
    got = k45({"cfg": cfg, "traffic": {"kind": "queries"}, "trace": {"units": 1, "kernels": kern}})
    bounds = (ys.k4_fwd(1024, 4096, 2).bound_s() + ys.k4_bwd(1024, 4096, 2).bound_s()
              + ys.k5_fwd(1024, 15, 2).bound_s() + ys.k5_bwd(1024, 15, 2).bound_s())
    assert got == pytest.approx(100 * bounds / (12.7e-6))


def test_build_work_counts_the_cells_real_rows():
    cfg = table_cfg()
    even = ys.build_work(cfg)
    counts = [244] * 4095 + [1_000_000 - 244 * 4095]
    uneven = ys.build_work(cfg, counts)
    assert uneven.tensor_flops > even.tensor_flops
    k2 = 2 * 1e6 * 4096 * 768 + 2 * 1e6 * 4096
    k3 = 2 * 1e6 * 4096 * 768 + 4 * 1e6 * 4096
    knn = 2 * 4096 * (1e6 / 4096) ** 2 * 768 + 4 * 4096 * (1e6 / 4096) ** 2
    assert even.tensor_flops == pytest.approx(k2 + k3 + knn)
