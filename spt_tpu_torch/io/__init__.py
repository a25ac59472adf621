"""Asset ingestion: Radiance ``.hdr`` read/write, cross-layout cubemaps,
glTF 2.0 (``.gltf`` / ``.glb``) and the native host library's RGBE decode
and cluster build (the counterparts of ``spt_tpu.io``)."""
