"""mfu.train: the model FLOPs of the timed window's training steps
(counts.py, at each utterance's own lengths, the backward as twice the
forward) over the window's wall time times 67 TFLOP/s, the H100 SXM
float32 peak outside the tensor cores, in %."""

from h100_bench.counts import FP32_FLOPS


def read(r):
    flops = r.get("model_flops")
    return None if flops is None else 100.0 * flops / (r["window_s"]
                                                       * FP32_FLOPS)
