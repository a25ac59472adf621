"""Integrators: the per-bounce transport and the masked wavefront loop."""

from spt_tpu_torch.integrators.transport import PathState, gen_primary, shade, trace_bounce
from spt_tpu_torch.integrators.wavefront import render_wavefront, wavefront_sample

__all__ = ["PathState", "gen_primary", "shade", "trace_bounce",
           "render_wavefront", "wavefront_sample"]
