"""The LM's model FLOPs (``counts/lm.py``: every prompt's prefill, every
served token's decode, valid tokens only) over the window's seconds, as a
share (%) of the card's bf16 peak."""


def read(run):
    if run.peaks is None:
        return None
    return 100.0 * run.job.model_flops() / run.window_s / run.peaks["bf16_flops"]
