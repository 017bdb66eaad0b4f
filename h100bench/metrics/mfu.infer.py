"""Percent of the card's bf16 dense peak (989 TFLOP/s) that the traced
run's unprofiled stretch reached: images per second times 1 x the
configuration's forward flops per image (recompute not counted)."""

from h100bench import work

PASSES = 1


def read(run):
    return 100.0 * work.mfu(run.rate_img_s, run.flops_per_image, PASSES)
