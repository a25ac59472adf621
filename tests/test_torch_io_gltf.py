"""spt_tpu_torch's glTF loader and native host library against spt_tpu's.

The loaders are copies over the same SceneDesc classes, so the arrays they
produce must be equal, exactly: positions, indices, normals, texcoords,
instance transforms, material factors and decoded textures.  The native
RGBE decode and cluster build must give the numpy paths' results bit for
bit, in the port and against the JAX package; they skip without ``g++``.
"""

import base64
import io
import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from spt_tpu.io import gltf as jgltf  # noqa: E402
from spt_tpu.io import hdr as jhdr  # noqa: E402
from spt_tpu.ops import bvh as jbvh  # noqa: E402
from spt_tpu.scene import flatten_scene as jflatten  # noqa: E402

from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch.engine.image import write_png  # noqa: E402
from spt_tpu_torch.io import gltf as tgltf  # noqa: E402
from spt_tpu_torch.io import hdr as thdr  # noqa: E402
from spt_tpu_torch.io import native  # noqa: E402
from spt_tpu_torch.ops import bvh as tbvh  # noqa: E402
from spt_tpu_torch.scene import builder as tbuilder  # noqa: E402
from spt_tpu_torch.scene import flatten_scene as tflatten  # noqa: E402

CPU = torch.device("cpu")


def _tri_gltf(tmp_path):
    """One triangle instanced twice (identity node + translated, scaled
    node), an external .bin (tests/test_io.py:126)."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    bin_data = positions.tobytes() + indices.tobytes() + b"\x00\x00"
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0},
                  {"mesh": 0, "translation": [5, 0, 0], "scale": [2, 2, 2],
                   "rotation": [0.0, 0.38268343, 0.0, 0.9238795]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.1, 0.1, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.4}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"uri": "data.bin", "byteLength": len(bin_data)}],
    }
    (tmp_path / "data.bin").write_bytes(bin_data)
    (tmp_path / "tri.gltf").write_text(json.dumps(doc))
    return str(tmp_path / "tri.gltf")


def textured_glb(path, res=16):
    """A .glb holding a textured quad: positions, normals, uvs, indices, a
    baseColor PNG and a metallicRoughness PNG in the BIN chunk, an emissive
    strength and a glass material (tests/test_io.py:174 plus textures)."""
    rng = np.random.default_rng(5)
    pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    images = []
    for _ in range(2):
        buf = io.BytesIO()
        png = os.path.join(os.path.dirname(path), f"t{len(images)}.png")
        write_png(png, rng.uniform(size=(res, res, 3)).astype(np.float32))
        with open(png, "rb") as f:
            buf.write(f.read())
        images.append(buf.getvalue())
    blobs = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes()] + images
    views, off, bin_chunk = [], 0, b""
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        b += b"\x00" * (-len(b) % 4)
        bin_chunk += b
        off += len(b)
    doc = {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0.5, 0]}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
             "indices": 3, "material": 0},
            {"attributes": {"POSITION": 0}, "indices": 3, "material": 1}]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1},
                "metallicFactor": 0.5, "roughnessFactor": 0.7},
             "emissiveFactor": [0.1, 0.2, 0.3],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 2.0}}},
            {"extensions": {"KHR_materials_transmission":
                            {"transmissionFactor": 1.0},
                            "KHR_materials_ior": {"ior": 1.45}}}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"bufferView": 4, "mimeType": "image/png"},
                   {"uri": "data:image/png;base64,"
                    + base64.b64encode(images[1]).decode()}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": 6,
             "type": "SCALAR"}],
        "bufferViews": views,
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total)
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    return path


def _assert_same_desc(a, b):
    assert len(a.meshes) == len(b.meshes) and len(a.instances) == len(b.instances)
    for ma, mb in zip(a.meshes, b.meshes):
        for f in ("positions", "indices", "normals", "texcoords"):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert ma.material_id == mb.material_id
    for ia, ib in zip(a.instances, b.instances):
        np.testing.assert_array_equal(ia.world_from_object, ib.world_from_object)
        assert (ia.mesh_id, ia.material_id) == (ib.mesh_id, ib.material_id)
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in ("base_color", "emission", "base_color_texture",
                  "metallic_roughness_texture"):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y)
        for f in ("metallic", "roughness", "ior", "transparency", "mat_type"):
            assert getattr(ma, f) == getattr(mb, f), f


def test_gltf_with_trs_matches_jax(tmp_path):
    path = _tri_gltf(tmp_path)
    got, want = tgltf.load_gltf(path), jgltf.load_gltf(path)
    _assert_same_desc(got, want)
    assert len(got.meshes) == 1 and len(got.instances) == 2
    dev = tflatten(got, CPU)
    jdev = jflatten(want)
    for f in ("tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      np.asarray(getattr(jdev, f)))
    np.testing.assert_allclose(dev.tri_v0[1].numpy(), [5, 0, 0], atol=1e-6)


def test_textured_glb_matches_jax(tmp_path):
    path = textured_glb(str(tmp_path / "quad.glb"))
    got, want = tgltf.load_gltf(path), jgltf.load_gltf(path)
    _assert_same_desc(got, want)
    m = got.materials
    assert m[0].base_color_texture is not None
    assert m[0].metallic_roughness_texture is not None
    assert m[1].mat_type == 1 and m[1].ior == pytest.approx(1.45)
    np.testing.assert_allclose(m[0].emission, [0.2, 0.4, 0.6], rtol=1e-6)
    # the textures land in the port's packed table as in JAX
    dev, jdev = tflatten(got, CPU), jflatten(want)
    np.testing.assert_array_equal(
        dev.textures.numpy(), interop.textures(jdev.textures, CPU).numpy())
    np.testing.assert_array_equal(dev.materials.tex_id.numpy(),
                                  np.asarray(jdev.materials.tex_id))


def test_bounding_box_matches_jax(tmp_path):
    desc = tgltf.load_gltf(_tri_gltf(tmp_path))
    desc.add_sphere(np.array([0.0, -3.0, 1.0], np.float32), 0.5)
    jdesc = jgltf.load_gltf(_tri_gltf(tmp_path))
    jdesc.add_sphere(np.array([0.0, -3.0, 1.0], np.float32), 0.5)
    lo, hi = tgltf.bounding_box(desc)
    jlo, jhi = jgltf.bounding_box(jdesc)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo[1] == pytest.approx(-3.5) and hi[0] > 5.0


def test_bad_glb_header_raises(tmp_path):
    p = tmp_path / "bad.glb"
    p.write_bytes(b"glTF" + struct.pack("<II", 1, 20) + b"\x00" * 8)
    with pytest.raises(ValueError, match="GLB"):
        tgltf.load_gltf(str(p))


def test_reference_chair():
    # the chair of the gltf / bigmesh / stream configs, where the repository
    # will hold it (tests/test_io.py:114)
    if not os.path.exists(tbuilder.CHAIR_GLTF):
        pytest.skip("no chair asset")
    sd = tgltf.load_gltf(tbuilder.CHAIR_GLTF)
    assert sd.total_triangles == 6116 and len(sd.instances) == 1
    lo, hi = tgltf.bounding_box(sd)
    assert 0.5 < hi[1] - lo[1] < 1.5


@pytest.mark.parametrize("build", ["build_chair_grid_scene",
                                   "build_unique_grid_scene"])
def test_chair_grids_name_the_missing_asset(build, tmp_path):
    missing = str(tmp_path / "scene.gltf")
    with pytest.raises(FileNotFoundError) as e:
        getattr(tbuilder, build)(path=missing)
    assert e.value.filename == missing
    if not os.path.exists(tbuilder.CHAIR_GLTF):
        with pytest.raises(FileNotFoundError, match="chair"):
            getattr(tbuilder, build)()


def test_chair_grids_match_jax_on_a_stand_in(tmp_path):
    # the grid builders on a small textured stand-in for the chair
    path = textured_glb(str(tmp_path / "quad.glb"))
    from spt_tpu.scene import builder as jbuilder

    for name in ("build_chair_grid_scene", "build_unique_grid_scene"):
        d, c, r = getattr(tbuilder, name)(2, 3, path=path)
        jd, jc, jr = getattr(jbuilder, name)(2, 3, path=path)
        _assert_same_desc(d, jd)
        np.testing.assert_array_equal(c, jc)
        assert r == jr


# --- the native host library ------------------------------------------------------

@pytest.fixture
def lib():
    if native.load() is None:
        pytest.skip("no native toolchain (g++)")
    return native.load()


@pytest.fixture
def numpy_only(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)


def _hdr_files(tmp_path):
    img = (np.random.default_rng(3).uniform(0, 30, (64, 128, 3)) ** 2)
    flat = str(tmp_path / "flat.hdr")
    thdr.write_hdr(flat, img.astype(np.float32))
    rle = str(tmp_path / "rle.hdr")
    w, h = 32, 4
    with open(rle, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for row in range(h):
            f.write(bytes([2, 2, 0, w]))
            f.write(bytes([w]) + bytes(range(10 + row, 10 + row + w)))
            for val in (64, 32, 136):
                f.write(bytes([128 + w, val]))
    return flat, rle


def test_native_rgbe_matches_numpy_and_jax(lib, tmp_path, monkeypatch):
    for path in _hdr_files(tmp_path):
        nat = thdr.read_hdr(path)
        with monkeypatch.context() as m:
            m.setattr(native, "load", lambda: None)
            py = thdr.read_hdr(path)
        np.testing.assert_array_equal(nat, py)
        np.testing.assert_array_equal(nat, jhdr.read_hdr(path))


def test_numpy_rgbe_without_native(numpy_only, tmp_path):
    for path in _hdr_files(tmp_path):
        np.testing.assert_array_equal(thdr.read_hdr(path), jhdr.read_hdr(path))


def _soup(n=777, seed=9, ties=False):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    if ties:  # a lattice of equal centroids along each axis
        v0 = np.round(v0).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    if ties:
        e1, e2 = np.tile(e1[:1], (n, 1)), np.tile(e2[:1], (n, 1))
    return v0, e1, e2, rng.integers(0, 5, n).astype(np.int32)


@pytest.mark.parametrize("ties", [False, True])
def test_native_cluster_build_matches_numpy_and_jax(lib, ties, monkeypatch):
    v0, e1, e2, mat = _soup(ties=ties)
    nat = tbvh.build_mesh_accel(v0, e1, e2, mat, device=CPU)
    with monkeypatch.context() as m:
        m.setattr(native, "load", lambda: None)
        py = tbvh.build_mesh_accel(v0, e1, e2, mat, device=CPU)
    want = jbvh.build_mesh_accel(v0, e1, e2, mat)
    for f in ("cluster_lo", "cluster_hi", "cl_okey", "tri_pack"):
        np.testing.assert_array_equal(getattr(nat, f).numpy(),
                                      getattr(py, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(nat, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_native_library_builds_under_the_checkout(lib):
    assert str(native.BUILD_ROOT) in lib._name
    assert not lib._name.startswith(os.path.join(
        os.path.dirname(str(native.SOURCE)), "lib"))
