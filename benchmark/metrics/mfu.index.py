"""The encoder's model FLOPs (``counts/encoder.py``: the valid tokens of
every passage the window encoded) over the window's seconds, as a share (%)
of the card's bf16 peak."""


def read(run):
    if run.peaks is None:
        return None
    return 100.0 * run.job.model_flops() / run.window_s / run.peaks["bf16_flops"]
