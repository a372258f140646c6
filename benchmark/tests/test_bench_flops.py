"""The yardstick's counts against hand counts from the widths."""

from benchmark import flops


def test_trunk_and_head_counts():
    # 8x256 trunk at 63 input channels, the layer after the skip 319 wide
    trunk = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
    assert trunk == 491_008
    per_sample, per_dir = flops.mlp_macs(256, 8, (4,), 63, 27)
    # density 256, feature 256x256, the direction layer's feature part 256x128, rgb 128x3
    assert per_sample == trunk + 256 + 65_536 + 32_768 + 384 == 589_952
    assert per_dir == 27 * 128
    # the offset net: 84 input channels, one 256x3 output layer
    assert flops.mlp_macs(256, 8, (4,), 84, 0, 3) == (84 * 256 + 4 * 65_536 + 340 * 256
                                                      + 2 * 65_536 + 768, 0)


def test_backward_counts_twice_the_forward():
    macs, params = flops.mlp_macs(256, 8, (4,), 63, 27), flops.mlp_params(256, 8, (4,), 63, 27)
    fwd = flops.mlp_work(macs, params, 1000, 10, False, False)[0]
    assert flops.mlp_work(macs, params, 1000, 10, False, True)[0] == 3 * fwd
    assert fwd == 2 * (1000 * 589_952 + 10 * 27 * 128)


def test_bkg_step_work_and_roofline():
    macs, params = flops.mlp_macs(256, 8, (4,), 63, 27), flops.mlp_params(256, 8, (4,), 63, 27)
    f, b = flops.mlp_work(macs, params, 4096 * 384, 2 * 4096, False, True)
    assert abs(f / 5.5677e12 - 1) < 1e-4
    # compute-bound at the f32 peak: ~83 ms
    assert abs(flops.roofline_s(f, b, "float32") - f / 67e12) < 1e-12
    assert 0.082 < flops.roofline_s(f, b, "float32") < 0.084
