"""spt_tpu_torch's CLI, bench entry, debug views, timing and viewer.

The parser is held to ``spt_tpu.cli``'s action by action (dest, default,
choices, flags).  The debug views are held to ``spt_tpu.integrators.debug``
per mode: geomtype, hitmiss and matid equal, depth within 1e-5 and normal
within 1e-4 (one closest-hit trace; XLA rounds the hit distance t in
another order, and a sphere's normal, the hit point less the centre over
the radius, carries that rounding amplified to about 2e-5).  The ANSI
frame is held to ``spt_tpu.engine.display._to_ansi`` byte for byte.  The
CLI and the bench run on the CPU (``device="cpu"``) at tiny sizes.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu import camera as jcamera  # noqa: E402
from spt_tpu import cli as jcli  # noqa: E402
from spt_tpu import config as jconfig  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.engine import display as jdisplay  # noqa: E402
from spt_tpu.integrators import debug as jdebug  # noqa: E402

from spt_tpu_torch import bench  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import cli  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine import display  # noqa: E402
from spt_tpu_torch.engine.image import read_png  # noqa: E402
from spt_tpu_torch.integrators import debug  # noqa: E402
from spt_tpu_torch.integrators.wavefront import WavefrontStats  # noqa: E402
from spt_tpu_torch.utils.timing import RayThroughput, StageTimer  # noqa: E402

CPU = torch.device("cpu")


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_matches_jax_action_by_action():
    mine, theirs = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert set(mine) == set(theirs)
    for dest, a in theirs.items():
        b = mine[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.choices == a.choices, dest
        assert b.type == a.type and b.nargs == a.nargs, dest
        assert type(b) is type(a), dest
    args = ["--i", "m.gltf", "--s", "e.hdr", "--scene", "cornell",
            "--tonemap", "aces", "--orbit", "3", "--debug-mode", "normal",
            "--integrator", "compact", "--no-swizzle", "-o", "x.png"]
    assert (vars(cli.build_parser().parse_args(args))
            == vars(jcli.build_parser().parse_args(args)))


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(["--help"])
    assert e.value.code == 0
    out = " ".join(capsys.readouterr().out.split())
    assert "--i" in out and "--s" in out and "no effect" in out


def test_bad_skybox_warns_and_continues(capsys, tmp_path):
    args = cli.build_parser().parse_args(
        ["--s", str(tmp_path / "nope.hdr"), "--width", "16", "--height", "16",
         "--spp", "1"])
    r = cli.make_renderer(args, device="cpu")
    assert r.env is not None and not bool(r.env.enabled)
    err = capsys.readouterr().err
    assert "warning" in err and "procedural sky" in err


@pytest.mark.parametrize("flags", [
    [], ["--integrator", "compact", "--scene", "cornell"],
    ["--integrator", "megakernel"], ["--integrator", "regen", "--stats"],
    ["--debug-mode", "normal"], ["--orbit", "5", "--tonemap", "aces"],
    ["--gltf"]])
def test_cli_main_writes_a_png(flags, tmp_path, capsys):
    out = str(tmp_path / "a.png")
    if flags == ["--gltf"]:
        from test_torch_io_gltf import textured_glb

        flags = ["--i", textured_glb(str(tmp_path / "q.glb"))]
    rc = cli.main(["--width", "32", "--height", "24", "--frames", "2",
                   "--spp", "1", "-o", out] + flags, device="cpu")
    assert rc == 0
    png = read_png(out)
    assert png.shape[:2] == (24, 32) and png.max() > 0
    text = capsys.readouterr().out
    assert "Wrote" in text
    if "--stats" in flags:
        assert "rays/bounce [768," in text


def test_cli_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    base = ["--width", "16", "--height", "12", "--spp", "1", "--depth", "2"]
    assert cli.main(base + ["--frames", "2", "--checkpoint", ck,
                            "-o", str(tmp_path / "a.png")], device="cpu") == 0
    assert cli.main(base + ["--frames", "1", "--resume", ck,
                            "-o", str(tmp_path / "b.png")], device="cpu") == 0
    assert "Resumed" in capsys.readouterr().out
    assert cli.main(["--width", "8", "--height", "8", "--resume", ck],
                    device="cpu") == 2
    assert cli.main(["--i", str(tmp_path / "none.gltf")], device="cpu") == 2


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--width", "8", "--height", "8"])


# --- debug views ----------------------------------------------------------------

@pytest.mark.parametrize("mode", list(jdebug.MODES))
@pytest.mark.parametrize("name", ["default", "triangle"])
def test_render_debug_matches_jax(mode, name):
    w, h = 48, 36
    if name == "triangle":
        pose = dict(position=(0, 0.5, 5), target=(0, 0.5, 0), fov_degrees=60.0,
                    aspect_ratio=w / h)
        jcam, tcam = jcamera.Camera(**pose), tcamera.Camera(**pose)
        jd, td = (jscene.build_test_triangle_scene(),
                  tscene.build_test_triangle_scene())
    else:
        jcam, tcam = jcamera.default_camera(w, h), tcamera.default_camera(w, h)
        jd, td = jscene.build_default_scene(), tscene.build_default_scene()
    want = np.asarray(jdebug.render_debug(
        jconfig.RenderConfig(width=w, height=h), jscene.flatten_scene(jd),
        jcam.rays(), mode))
    got = debug.render_debug(tconfig.RenderConfig(width=w, height=h),
                             tscene.flatten_scene(td, CPU), tcam.rays(CPU),
                             mode).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    if mode in ("normal", "depth"):
        tol = 1e-4 if mode == "normal" else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)
    assert debug.MODES == jdebug.MODES


def test_render_debug_bad_mode():
    cfg = tconfig.RenderConfig(width=8, height=8)
    with pytest.raises(ValueError):
        debug.render_debug(cfg, tscene.flatten_scene(tscene.build_default_scene(),
                                                     CPU),
                           tcamera.default_camera(8, 8).rays(CPU), "bogus")


# --- timing ---------------------------------------------------------------------

def test_stage_timer():
    import time

    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("b", block_on=torch.ones(4)):
        pass
    assert t.totals["a"] >= 0.02 and t.counts["a"] == 2
    assert "a" in t.report() and "b" in t.report()


def test_ray_throughput_matches_jax():
    from spt_tpu.utils.timing import RayThroughput as JaxRT
    from spt_tpu.integrators.wavefront import WavefrontStats as JaxStats

    rt, jrt = RayThroughput(n_lights=1), JaxRT(n_lights=1)
    rays = [100, 40, 10, 0]
    rt.add_frame(WavefrontStats(rays_per_bounce=torch.tensor(rays),
                                bounces_run=torch.tensor(3)))
    jrt.add_frame(JaxStats(rays_per_bounce=jnp.array(rays),
                           bounces_run=jnp.int32(3)))
    assert rt.total_rays == jrt.total_rays == 200   # 150 path + 50 shadow
    assert rt.mrays_per_sec > 0
    assert "Mrays" in rt.report()


# --- the ANSI viewer --------------------------------------------------------------

@pytest.mark.parametrize("shape,cols,rows", [((20, 30), 15, 5),
                                             ((37, 53), 40, 12),
                                             ((4, 4), 40, 12)])
def test_to_ansi_matches_jax(shape, cols, rows):
    img = np.random.default_rng(2).uniform(size=shape + (3,)).astype(np.float32)
    frame = display._to_ansi(img, cols, rows)
    assert frame == jdisplay._to_ansi(img, cols, rows)
    assert len(frame.split("\n")) == rows and frame.endswith("\x1b[0m")


# --- the bench entry ------------------------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame", "spp",
              "max_depth"}


@pytest.mark.parametrize("name", ["default", "cornell", "hdr"])
def test_build_workload_matches_bench_configs(name):
    r = bench.build_workload(name, 32, 24, device="cpu")
    depth = {"cornell": 8}.get(name, 6)
    assert (r.cfg.width, r.cfg.height, r.cfg.spp, r.cfg.max_depth) == (
        32, 24, 1, depth)
    assert bool(r.env.enabled) == (name == "hdr")
    assert bench.shadow_rays_per_surface_lane(r) == {"default": 1,
                                                     "cornell": 1,
                                                     "hdr": 1}[name]


@pytest.mark.parametrize("name", ["gltf", "bigmesh", "stream"])
def test_chair_configs_name_the_asset(name):
    from spt_tpu_torch.scene.builder import CHAIR_GLTF
    import os

    if os.path.exists(CHAIR_GLTF):
        pytest.skip("the chair asset is present")
    with pytest.raises(FileNotFoundError) as e:
        bench.build_workload(name, 32, 24, device="cpu")
    assert e.value.filename == CHAIR_GLTF


def test_bench_quick_chain_prints_the_line(capsys):
    assert bench.main(["--quick", "--iters", "1"], device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert BENCH_KEYS <= set(res)
    assert res["metric"] == "wavefront_mrays_per_sec_default_scene_640x480"
    assert res["unit"] == "Mrays/s" and res["value"] > 0
    assert res["vs_baseline"] == round(res["value"] / bench.TARGET_MRAYS, 3)
    assert (res["spp"], res["max_depth"], res["device"]) == (1, 6, "cpu")
