"""The frozen copy of the kernels' work counts and peaks equals
``chip_smoke.py``'s arithmetic (over the port's plain versions) on seeded
inputs at one shape each."""

import importlib.util

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.spec import ROOT


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks_and_bound_equal_chip_smoke(chip_smoke):
    assert roofline.HBM_BYTES_S == chip_smoke.HBM_BYTES_S
    assert roofline.F32_OPS_S == chip_smoke.F32_OPS_S
    assert roofline.K2_OPS_PER_TILE_SWEEP == chip_smoke.K2_OPS_PER_TILE_SWEEP
    assert roofline.K1_OPS_PER_CONE_TEST == chip_smoke.K1_OPS_PER_CONE_TEST
    for nbytes, ops in ((3.2e7, 6.4e8), (1.7e6, 6.06e8), (1e9, 1.0)):
        assert roofline.bound(nbytes, ops) == chip_smoke.bound(nbytes, ops)


@pytest.mark.parametrize("exact", [True, False])
def test_k1_count_equals_chip_smoke(chip_smoke, exact):
    from permafrost_engine_tpu_torch.ops.crowd_cuda import hrvo_select_plain

    args = [torch.from_numpy(a) for a in chip_smoke.k1_edge_scene(
        256, 144, 0, seed=7)]
    stats = {}
    hrvo_select_plain(*args, exact=exact, stats=stats)
    n, c2 = args[5].shape[0], args[5].shape[1]
    every, passed, inside = chip_smoke.K1_OPS_PER_CONE_TEST[
        "exact" if exact else "fan"]
    ops = (n * (5 * c2 + 32 * c2) + stats["pairs"] * every
           + stats["passed"] * passed + stats["inside"] * inside)
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * 2 * 4
    assert roofline.k1_work(args, exact) == (float(ops), float(nbytes))


def test_k2_count_equals_chip_smoke(chip_smoke):
    from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

    rng = np.random.default_rng(11)
    cost = np.ones((4, 64, 64), np.uint8)
    cost[rng.random(cost.shape) < 0.15] = 255
    seeds = np.zeros(cost.shape, bool)
    seeds[np.arange(4), rng.integers(4, 60, 4), rng.integers(4, 60, 4)] = True
    ct, st = torch.from_numpy(cost), torch.from_numpy(seeds)
    stats = {}
    integrate_plain(ct, st, None, max_iters=256, stats=stats)
    k, h, w = cost.shape
    want = (float(stats["sweeps"] * k * h * w
                  * chip_smoke.K2_OPS_PER_TILE_SWEEP),
            float(k * h * w * (1 + 1 + 4)))
    assert roofline.k2_work(ct, st, None, 256) == want
