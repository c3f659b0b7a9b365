"""Share (%) of its roofline that the encoder's attention reaches in the
profiled build call: the least time for the operations (at the bf16 peak)
or the bytes (at the HBM peak), whichever is more, that each passage's
valid tokens need (``counts/encoder.py``), over the device time of the
kernels of ``prefill_attention.cu`` (by name)."""

from benchmark.counts import encoder

KERNELS = ("prefill_attn", "prefill_prep", "prefill_vsum")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.device_seconds(KERNELS)
    lengths = getattr(run.job, "trace_counts", {}).get("lengths")
    if not seconds or not lengths:
        return None
    c = run.job.c
    bound = max(encoder.attention_flops(c, lengths) / run.peaks["bf16_flops"],
                encoder.attention_bytes(c, lengths) / run.peaks["hbm_bytes"])
    return 100.0 * bound / seconds
