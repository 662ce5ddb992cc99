"""The whole study's share of the card's FP32 peak: every study's
operations (h100_bench/work/k1.py) over the window's length."""

from h100_bench.work import k1


def read(rec):
    axes, mix = rec["config"]["axes"], rec["mix"]
    flops, _ = k1.study_work(2 * axes, axes, mix["members"], mix["steps"])
    return 100.0 * flops * rec["requests"] / rec["window_s"] / k1.PEAK_FP32
