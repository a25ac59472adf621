"""Asset ingestion: Radiance ``.hdr`` read/write and cross-layout cubemaps
(numpy only; the counterparts of ``spt_tpu.io.hdr`` and
``spt_tpu.io.cubemap_cross``).  The JAX package's glTF loader and native
decoder are not ported."""
