"""The yardstick's arithmetic at small shapes against hand-worked values
(CPU): the WN roles' operations and bytes, the model FLOPs, the peaks,
and the device trace's busy union and idle gaps."""

import pytest

from perfbench import roofline
from perfbench.trace import Observation, breakdown, busy_s, union_us

SMALL_WG = {"n_mel_channels": 2, "n_group": 2, "wn_n_channels": 4,
            "wn_n_layers": 2, "wn_kernel_size": 3, "n_flows": 3,
            "n_early_every": 2, "n_early_size": 2, "upsample_kernel": 8,
            "upsample_stride": 4}


@pytest.mark.parametrize("role, ops, bytes_", [
    # B=1, T=2, C=4, M=3, n_half=2: bt = 4; taps 4*3*4*8 = 384, cond
    # 4*3*8 = 96, res/skip 4*4*8 = 128
    ("std", 608, 476),
    # taps of rank n_half 4*3*2*8 = 192, start 4*2*4 = 32
    ("first", 448, 452),
    # end projection 2*4*4*E(4) = 128
    ("final", 608, 460),
])
def test_wn_role_work(role, ops, bytes_):
    assert roofline.wn_role_work(role, 1, 2, 4, 3, 2) == (ops, bytes_)


def test_wn_role_work_rejects_unknown_roles():
    with pytest.raises(ValueError):
        roofline.wn_role_work("partial", 1, 2, 4, 3, 2)


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(989e9, 0) == pytest.approx(1e-3)
    assert roofline.bound_s(0, 3.35e9) == pytest.approx(1e-3)
    assert roofline.bound_s(67e9, 0, "f32") == pytest.approx(1e-3)
    assert roofline.PEAK_FLOPS["tf32"] == 495e12
    assert roofline.PEAK_FLOPS["int8"] == 1979e12


def test_flow_halves_follow_the_early_outputs():
    # 2 channels; the early output at flow 2 leaves none: halves 1, 1, 0
    assert roofline.flow_halves(SMALL_WG) == [1, 1, 0]
    full = dict(SMALL_WG, n_group=8, n_flows=12, n_early_every=4)
    assert roofline.flow_halves(full) == [4] * 4 + [3] * 4 + [2] * 4


def test_wn_flops_per_group():
    # 2 (n_half C + L K C 2C + L M 2C + (L-1) C 2C + C C + C 2 n_half)
    # = 2 (4 + 192 + 64 + 32 + 16 + 8)
    assert roofline.wn_flops_per_group(SMALL_WG, 1) == 632


def test_vocode_bound_sums_each_flows_launches():
    wg = dict(SMALL_WG, wn_n_layers=3)
    T = 5 * 4 // 2
    want = sum(roofline.bound_s(*roofline.wn_role_work(r, 2, T, 4, 4, h))
               * n for h in roofline.flow_halves(wg)
               for r, n in (("first", 1), ("std", 1), ("final", 1)))
    assert roofline.vocode_wn_bound_s(wg, 2, 5) == pytest.approx(want)


def test_reference_width_vocoder_is_about_17_gflop_a_frame():
    wg = {"n_mel_channels": 80, "n_group": 8, "wn_n_channels": 512,
          "wn_n_layers": 8, "wn_kernel_size": 3, "n_flows": 12,
          "n_early_every": 4, "n_early_size": 2, "upsample_kernel": 1024,
          "upsample_stride": 256}
    assert 16.5e9 < roofline.vocoder_flops_per_frame(wg) < 17.5e9


def test_decoder_and_postnet_flops():
    hp = {"n_mel_channels": 2, "prenet_dim": 3, "enc_conv_channels": 4,
          "attention_rnn_dim": 5, "decoder_rnn_dim": 6, "attention_dim": 2,
          "attention_location_n_filters": 1,
          "attention_location_kernel_size": 3,
          "postnet_n_convolutions": 3, "postnet_embedding_dim": 4,
          "postnet_kernel_size": 5}
    # MACs 6 + 9 + 12*20 + 15*24 + 10 + 10 (6 + 2 + 2 + 4) + 10*3 = 795
    assert roofline.decoder_flops_per_frame(hp, 10) == 1590
    # dims 2, 4, 4, 2: 2 * 5 * (8 + 16 + 8)
    assert roofline.postnet_flops_per_frame(hp) == 320


def test_train_flops_are_three_forwards():
    one = roofline.train_flops_per_row(SMALL_WG, 16)
    # 8 groups, 5 mel frames: upsample 2*2*2*8*5, WN 8 * (632 + 632 + 0)
    halves = roofline.flow_halves(SMALL_WG)
    wn = 8 * sum(roofline.wn_flops_per_group(SMALL_WG, h) for h in halves)
    assert one == 3 * (2 * 2 * 2 * 8 * 5 + wn)


def test_busy_is_the_union_of_intervals():
    assert union_us([(0, 10), (5, 10), (30, 5)]) == 20
    obs = Observation(ops=[("a", 0.0, 10.0), ("b", 5.0, 10.0),
                           ("c", 30.0, 5.0)], slice_s=(0.0, 50e-6))
    assert busy_s(obs) == pytest.approx(20e-6)


def test_breakdown_names_idle_gaps_by_the_innermost_span():
    obs = Observation(ops=[("k1", 0.0, 10.0), ("k2", 40.0, 10.0),
                           ("k1", 60.0, 5.0)], slice_s=(0.0, 100e-6))
    obs.spans = [("batch", 0.0, 100e-6), ("decode", 10e-6, 40e-6)]
    b = breakdown(obs)
    assert b["device_ops"] == [["k1", pytest.approx(15e-6)],
                               ["k2", pytest.approx(10e-6)]]
    assert b["idle_gaps"][0] == ["batch", pytest.approx(35e-6)]
    assert b["idle_gaps"][1] == ["decode", pytest.approx(30e-6)]
    assert b["idle_gaps"][2] == ["batch", pytest.approx(10e-6)]
