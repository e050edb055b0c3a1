"""Model FLOPs of the frames completed in the window, counted from the
configuration's widths and each frame's tokens, as a share of the
H100's bf16 peak over the window, in percent."""
from perfbench import counts, peaks, window


def read(rec):
    flops = sum(n * counts.vit_flops(rec["model"], res)
                for _, _, n, res in window.counted(rec))
    return 100.0 * flops / (peaks.BF16_FLOPS * window.seconds(rec))
