"""The whole step's share of the chip's peak: the model FLOPs that the
window's inputs need (``facts["model_flops"]``, counted by the entry from
the real tokens and shapes, no padding and no recomputation) over the
window's wall, over the peak of the type the configuration computes in
(``facts["peak_flops"]``, from ``roofline.PEAKS``)."""


def read(run):
    f = run.facts
    if not run.trace or not f.get("wall_s") or not f.get("model_flops"):
        return None
    return 100.0 * f["model_flops"] / f["wall_s"] / f["peak_flops"]
