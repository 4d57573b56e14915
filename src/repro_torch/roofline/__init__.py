"""repro_torch.roofline — the three-term roofline of the port's work on
one H100: analytic counts of each kernel entry and program (``cost``),
the card's peaks (``hw``) and the roofline over them (``analysis``)."""

from repro_torch.roofline.analysis import Roofline, analyze, collective_bytes, model_flops
from repro_torch.roofline.cost import Cost

__all__ = ["Cost", "Roofline", "analyze", "collective_bytes", "model_flops"]
