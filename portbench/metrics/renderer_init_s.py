"""Host seconds of the Renderer's constructor, the port's own set-up span
"renderer_init" (flatten, environment and lights, state; on several cards
the mesh and the replication too): scene_build_s without the imports and
the benchmark's scene conversion.  On several cards rank 0's."""

from portbench import program_spans


def read(run):
    return program_spans.first_span_s(run, "renderer_init")
