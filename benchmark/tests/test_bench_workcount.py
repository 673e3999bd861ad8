"""The frozen work counts at the NeFeS field's widths (D8/W128/F128, 10
and 4 frequency bands) against values worked by hand, and the bounds
against the kernel table the program's time phase printed."""

import pytest

from benchmark import workcount as wc

D = wc.FieldDims()
# trunk: 63·128 + 7·128² + 128 (sigma) + 63·128 (the skip) = 130,944;
# body: + 128² + (128 + 27)·64 = 157,248; full: + 64·131 = 165,632;
# the transient branch: 155·64 + 2·64² + 64·5 = 18,432
HAND = {"K1": 2 * 130944, "full": 2 * 165632, "K2": 2 * (157248 + 165632),
        "K4": 2 * (157248 + 64 * 3 + 165632),
        "K3": 2 * (157248 + 64 * 131 / 128),
        "fwd_t": 2 * (165632 + 18432),
        "bwd_dw_t": 2 * ((157248 + 18432) + 2 * (165632 + 18432))}


@pytest.mark.parametrize("key", sorted(HAND))
def test_tower_flops_by_hand(key):
    assert wc.tower_flops(D, samples=128)[key] == pytest.approx(HAND[key])


def test_embed_ops_by_hand():
    # 3 phases x 3 coordinates per band; back: 7 operations per band
    assert wc.embed_ops(D) == {"xyz_fwd": 90, "fwd": 126, "bwd": 294}


# the bound column of the port's kernel table (60x80 rays, 64 + 128
# samples; ms)
TABLE_MS = {"field_fwd_pre": 0.0813, "field_bwd_pre": 0.4012,
            "render_fwd_pre": 0.1955, "render_bwd_pre": 0.4014,
            "field_fwd": 0.0818, "field_bwd": 0.4050,
            "render_fwd": 0.1966, "render_bwd": 0.4053}


@pytest.mark.parametrize("wrapper", sorted(TABLE_MS))
def test_refinement_bounds_match_kernel_table(wrapper):
    got = wc.refinement_kernel_bounds(D, 60 * 80)[wrapper]
    assert round(got, 4) == TABLE_MS[wrapper]


def test_bound_picks_the_larger():
    assert wc.bound(989e9, 0, 0) == (pytest.approx(1.0), "operations")
    assert wc.bound(0, 0, 3.35e9)[1] == "bytes"
    assert wc.bound(0, 67e9, 0)[0] == pytest.approx(1.0)


def test_training_bound_is_operations_bound_sum():
    # four passes, each bound by its products at these sizes
    ms = wc.train_step_kernel_bound(D, 6144)
    fl = wc.tower_flops(D)
    ops = 6144 * (64 * (fl["full"] + fl["K2"] + fl["full"])
                  + 128 * (fl["fwd_t"] + fl["bwd_dw_t"]))
    assert ms >= ops / wc.PEAK_BF16_FLOPS * 1e3
