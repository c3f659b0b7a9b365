"""Share (%) of its roofline that the decode step's attention reaches in the
profiled chunk: the least time the card could take for the bytes and
operations the steps need (``counts/lm.py``: each row's valid slots at each
step, not the static cache), over the device time of the kernels that
``ops/attention.py::decode_attention`` launches (by name)."""

from benchmark.counts import lm

KERNELS = ("attn_scores", "attn_values", "attn_combine")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.device_seconds(KERNELS)
    counts = getattr(run.job, "trace_counts", {})
    gens = counts.get("generations")
    if not seconds or not gens or not counts.get("decode_attention_launches"):
        return None
    c = run.job.c
    steps = counts["decode_attention_launches"] / c["num_hidden_layers"] / len(gens)
    need = sum(lm.decode_attention_bytes(c, enc, steps) for enc, _ in gens)
    ops = sum(lm.decode_attention_flops(c, enc, steps) for enc, _ in gens)
    bound = max(need / run.peaks["hbm_bytes"], ops / run.peaks["bf16_flops"])
    return 100.0 * bound / seconds
