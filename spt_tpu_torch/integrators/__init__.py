"""Integrators: one transport, three orchestrations.

`transport` holds the per-bounce physics; `wavefront` runs the staged depth
loop over SoA path state (masked, compact and regen lane scheduling);
`megakernel` loops bounces over the whole pixel batch in plain PyTorch (the
differentiable path); `debug` renders single-bounce visualizations.
"""

from spt_tpu_torch.integrators.transport import PathState, gen_primary, shade, trace_bounce
from spt_tpu_torch.integrators.megakernel import render_megakernel, render_sample
from spt_tpu_torch.integrators.wavefront import render_wavefront, wavefront_sample

__all__ = ["PathState", "gen_primary", "shade", "trace_bounce",
           "render_megakernel", "render_sample",
           "render_wavefront", "wavefront_sample"]
