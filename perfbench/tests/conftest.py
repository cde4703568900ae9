"""Shared sizes for the benchmark's CPU tests: each cell cut to a few
antennas and channels, so that a run on the CPU takes a second."""

import pytest

SMALL = {
    "flagship": {"config": {"nant": 6, "nchan": 32,
                            "layout": [{"count": 6, "box_m": 5657.0}]},
                 "traffic": {"pool_chunks": 2, "kept_rows": 4, "kept_calls": 2,
                             "traced_calls": 2, "warmup_calls": 1,
                             "sky": {"count": 5}}},
    "selfcal": {"config": {"nant": 8, "nchan": 4,
                           "layout": [{"count": 3, "box_m": 5657.0},
                                      {"count": 5, "radius_m": [500.0, 75000.0]}]},
                "traffic": {"npx": 8, "pool_draws": 2, "kept_calls": 2,
                            "dirty_pixels": 8, "traced_calls": 2,
                            "warmup_calls": 1, "sky": {"count": 3}}},
}


@pytest.fixture
def small():
    return SMALL
